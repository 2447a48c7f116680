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

import contextlib
import contextvars
import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import collectives, func_rules, pcg32_hash, threefry
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
    (grid_hash, common_device.h:678-691); Rng through ``pcg32_hash``."""
    if hash_type == HashType.RNG:
        return pcg32_hash.rng_hash(coords)
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


def level_indices(spec: GridSpec, level: LevelSpec, pos_grid: torch.Tensor) -> torch.Tensor:
    """Table rows of integer grid coordinates on one level
    (``tcnn_tpu/ops/grid_ops.py:220``): ``pos_grid`` (..., D) uint32 values
    held in an integer tensor → (...,) int32 rows of the whole table (the
    level's offset included), the hash or dense strides wrapping at 32
    bits."""
    coords = [pos_grid[..., d].to(torch.int64) & _U32 for d in range(spec.n_dims)]
    if level.use_hash:
        idx = _hash_coords(spec.hash_type, coords)
    else:
        idx = torch.zeros_like(coords[0])
        for d in range(spec.n_dims):
            if level.stride_mask[d]:
                idx = (idx + _mul_u32(coords[d], level.strides[d])) & _U32
    return (idx % level.size + level.offset).to(torch.int32)


def init_grid_params(generator: Optional[torch.Generator], spec: GridSpec,
                     scale: float = 1.0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n_entries, F) table drawn U(−1e-4·scale, 1e-4·scale) on the CPU from
    ``generator`` (grid.h:1059-1062; ``tcnn_tpu/ops/grid_ops.py:1300``, which
    takes a JAX key: the two draw other numbers from one seed)."""
    table = torch.empty((spec.n_entries, spec.n_features_per_level), dtype=dtype)
    return table.uniform_(-1e-4 * scale, 1e-4 * scale, generator=generator)


def _interp_weight(f: torch.Tensor, interp: InterpolationType) -> torch.Tensor:
    """Cell-relative fraction → interpolation weight (common_device.h:801-811)."""
    if interp == InterpolationType.LINEAR:
        return f
    if interp == InterpolationType.SMOOTHSTEP:
        return f * f * (3.0 - 2.0 * f)
    if interp == InterpolationType.NEAREST:
        return (f > 0.5).to(f.dtype)
    raise ValueError(f"bad interpolation {interp}")


def _interp_derivatives(f: torch.Tensor, interp: InterpolationType):
    """First, second and third derivative of ``_interp_weight`` in f:
    Linear 1, 0 and 0, Smoothstep 6f(1 − f), 6 − 12f and −12, Nearest 0."""
    if interp == InterpolationType.LINEAR:
        return torch.ones_like(f), torch.zeros_like(f), torch.zeros_like(f)
    if interp == InterpolationType.SMOOTHSTEP:
        return 6.0 * f * (1.0 - f), 6.0 - 12.0 * f, torch.full_like(f, -12.0)
    return torch.zeros_like(f), torch.zeros_like(f), torch.zeros_like(f)


def live_levels(spec: GridSpec, max_level: Optional[int]) -> List[int]:
    """Levels below the static ``max_level`` cutoff (grid.h:69-92)."""
    return [li for li in range(spec.n_levels)
            if max_level is None or li < max_level]


def level_mask(spec: GridSpec, live: Sequence[int],
               level_frac: torch.Tensor) -> torch.Tensor:
    """(L_live, B) float32 per-sample level mask of the coarse-to-fine
    schedule (``tcnn_tpu/ops/grid_ops.py:1215-1228``; the CUDA original's
    ``max_level_gpu``, grid.h:69-92): live level l is kept for sample b iff
    ``float(l) < frac[b]·n_levels + 1e-3``, the product rounded to fp32 and
    then the sum, as in JAX (two kernels, never a fused multiply-add)."""
    thr = level_frac.to(torch.float32).reshape(1, -1) * float(spec.n_levels) + 1e-3
    lvl = torch.tensor(list(live), dtype=torch.float32,
                       device=level_frac.device).reshape(-1, 1)
    return (lvl < thr).to(torch.float32)


STOCHASTIC_SEED = 1337
_uniforms: dict = {}


def stochastic_uniforms(n_levels: int, batch: int, device) -> torch.Tensor:
    """The (n_levels, B) float32 uniforms of stochastic interpolation,
    ``jax.random.uniform(jax.random.key(1337), (n_levels, B))`` bit for bit
    (``tcnn_tpu/ops/grid_ops.py:524-535``; ``threefry``), computed once per
    (n_levels, B, device) and kept, so that a training step, and a CUDA
    graph captured around it, allocates nothing for them.  Level l's row
    is row l, whichever levels are live."""
    key = (n_levels, batch, torch.device(device))
    if key not in _uniforms:
        _uniforms[key] = threefry.uniform(STOCHASTIC_SEED, (n_levels, batch), device)
    return _uniforms[key]


def build_indices_weights(spec: GridSpec, x: torch.Tensor,
                          live: Sequence[int], order: int = 0,
                          level_frac: Optional[torch.Tensor] = None,
                          scatter: bool = False, shard: Optional[Tuple[int, int]] = None):
    """Corner row indices and interpolation weights of the live levels.

    Same layout as the JAX package's ``_build_indices_weights``:
      idx: (L, C·B) int64 whole-table rows (level offsets folded in),
           corner-major within a level.
      ws:  (L·C, B) float32 corner weights, row l·C + c.
    With ``order`` 1 to 3 it also returns the weights' derivatives in x:
      dws:  (L·C, B, D) ∂w/∂x_d;
      d2ws: (L·C, B, D, D) ∂²w/∂x_d∂x_e (order 2);
      d3ws: (L·C, B, D, D, D) ∂³w/∂x_d∂x_e∂x_f (order 3).
    They come from the closed-form per-dim derivatives (floor has zero
    derivative, so d fract/dx is the level's scale) by the product rule
    over the dims, as kernels GI and GG compute them, not from autograd;
    JAX differentiates ``f*f*(3 − 2f)`` by autodiff, which rounds
    differently.  With ``level_frac`` (B,) the weights and their
    derivatives of a masked (sample, level) are multiplied by 0
    (``level_mask``), as JAX multiplies its ``ws``: the sample's output,
    table gradient and input gradient on that level are zero.

    ``scatter``: ``ws`` are the weights the table gradient scatters with,
    JAX's ``ws_bwd``.  They are the corner weights but under stochastic
    interpolation (grid.h:284-299; ``tcnn_tpu/ops/grid_ops.py:524-535``),
    where each (level, sample) puts weight 1 on one corner, cell + 1 on dim
    d iff u < w1_d (u from ``stochastic_uniforms``, w1_d the weight of the
    upper corner on dim d, Smoothstep included), and 0 on the others.  The
    forward and the input gradient keep the ordinary weights.

    ``shard`` (sid, n): the table is this rank's block-cyclic shard
    (``sharded_tables``).  A corner whose level-local row r lies in the
    rank's block [sid·size/n, (sid+1)·size/n) gets its row in the shard,
    r − sid·size/n + offset/n; any other corner gets row −1 and zero
    weights (and weight derivatives), so it contributes nothing.
    ``interpolate_ref`` and the plain versions read row −1 as row 0, at
    weight 0.
    """
    B = x.shape[0]
    D = spec.n_dims
    C = 1 << D
    levels = [spec.levels[li] for li in live]
    L = len(levels)
    bits = _corner_offsets(D)
    scales = torch.tensor([lv.scale for lv in levels], dtype=torch.float32,
                          device=x.device).reshape(L, 1)

    cells, w1s, dw1s, d2w1s, d3w1s = [], [], [], [], []
    for d in range(D):
        # Two roundings, like JAX's separate multiply and add: a fused
        # multiply-add would move samples near a cell border.
        pos = x[:, d].to(torch.float32)[None, :] * scales + 0.5
        cf = torch.floor(pos)
        # (uint32)(int)floorf: negatives wrap exactly like CUDA.
        cells.append(cf.to(torch.int64) & _U32)
        w1s.append(_interp_weight(pos - cf, spec.interpolation))
        if order:
            d1, d2, d3 = _interp_derivatives(pos - cf, spec.interpolation)
            dw1s.append(d1 * scales)
            d2w1s.append(d2 * scales * scales)
            d3w1s.append(d3 * scales * scales * scales)

    def factor(c, d):   # corner c's factor of dim d, (L, B)
        return w1s[d] if bits[c, d] else 1.0 - w1s[d]

    def dfactor(c, d, k):   # its k-th derivative in x_d
        df = (dw1s, d2w1s, d3w1s)[k - 1][d]
        return df if bits[c, d] else -df

    def product(c, derivs):   # Π_d of corner c's factors, dim d derived derivs[d] times
        w = None
        for d in range(D):
            f = dfactor(c, d, derivs[d]) if derivs[d] else factor(c, d)
            w = f if w is None else w * f
        return w

    if scatter and spec.stochastic_interpolation:
        u = stochastic_uniforms(spec.n_levels, B, x.device)[list(live)]
        w1s = [(u < w1).to(torch.float32) for w1 in w1s]
    ws = torch.stack([product(c, [0] * D) for c in range(C)], dim=1).reshape(L * C, B)
    mask = (level_mask(spec, live, level_frac).repeat_interleave(C, dim=0)
            if level_frac is not None else None)
    out = [ws if mask is None else ws * mask]
    if order >= 1:
        out.append(torch.stack(
            [torch.stack([product(c, [int(d == e) for d in range(D)]) for e in range(D)], -1)
             for c in range(C)], dim=1).reshape(L * C, B, D))
    if order >= 2:
        out.append(torch.stack(
            [torch.stack([torch.stack([product(c, [int(d == e) + int(d == f) for d in range(D)])
                                       for f in range(D)], -1) for e in range(D)], -2)
             for c in range(C)], dim=1).reshape(L * C, B, D, D))
    if order >= 3:
        def d3(c, e, f, g):
            return product(c, [int(d == e) + int(d == f) + int(d == g) for d in range(D)])
        out.append(torch.stack(
            [torch.stack([torch.stack([torch.stack([d3(c, e, f, g) for g in range(D)], -1)
                                       for f in range(D)], -2) for e in range(D)], -3)
             for c in range(C)], dim=1).reshape(L * C, B, D, D, D))
    if mask is not None:
        out[1:] = [o * mask.reshape(L * C, B, *[1] * (o.ndim - 2)) for o in out[1:]]

    rows, owned = [], []
    corner_bits = torch.from_numpy(bits).to(x.device)   # (C, D)
    for p, lv in enumerate(levels):
        # every corner at once: (C, B) coordinates per dim
        coords = [(cells[d][p][None, :] + corner_bits[:, d:d + 1]) & _U32 for d in range(D)]
        if lv.use_hash:
            h = _hash_coords(spec.hash_type, coords)
        else:
            h = torch.zeros_like(coords[0])
            for d in range(D):
                if lv.stride_mask[d]:
                    h = (h + _mul_u32(coords[d], lv.strides[d])) & _U32
        if shard is None:
            rows.append(h % lv.size + lv.offset)   # (C, B)
            continue
        n_rows = lv.size // shard[1]
        r = h % lv.size - shard[0] * n_rows
        own = (r >= 0) & (r < n_rows)
        rows.append(torch.where(own, r + lv.offset // shard[1], -1))
        owned.append(own)
    idx = torch.stack(rows, dim=0).reshape(L, C * B)
    if owned:
        own = torch.stack(owned, dim=0).reshape(L * C, B).to(torch.float32)
        out = [o * own.reshape(L * C, B, *[1] * (o.ndim - 2)) for o in out]
    return (idx, *out)


def interpolate_ref(flat: torch.Tensor, idx: torch.Tensor, ws: torch.Tensor,
                    n_features: int) -> torch.Tensor:
    """(L·F, B) float32 columns: Σ_c ws[l·C+c, b] · table[idx[l, c·B+b], f]
    (a row −1, a corner another shard owns, is read as row 0 at weight 0)."""
    L = idx.shape[0]
    B = ws.shape[1]
    C = ws.shape[0] // L
    table2d = flat.reshape(-1, n_features)
    feats = table2d[idx.reshape(-1).clamp_min(0)].to(torch.float32)
    feats = feats.reshape(L, C, B, n_features)
    cols = (feats * ws.reshape(L, C, B, 1)).sum(dim=1)     # (L, B, F)
    return cols.permute(0, 2, 1).reshape(L * n_features, B)


LEVEL_FIELDS = 17
MAX_DIMS = 7   # the hash primes' count (common_device.h:646-664)


def level_params(spec: GridSpec, live: Sequence[int],
                 shard: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Per-level constants of the grid kernels, (L, 17) int32:
    scale (float32 bits), size, row base, use_hash, live, stride-mask bits,
    seven uint32 strides (bit patterns; zero past n_dims), the 64-bit
    multiplier of ``h % size`` without a division,
    floor((2^64 − 1) / size) + 1 (Lemire, Kaser & Kurz, 2019), as low and
    high words, and the table rows the kernel holds of the level: the
    first and their count.  Dead levels (at or above ``max_level``) keep
    their row, marked not live.

    A corner's table row is (h mod size) + row base.  Unsharded the row
    base is the level's offset and the kernel holds all its rows (offset,
    size).  With ``shard`` (sid, n), the block-cyclic shard of
    ``sharded_tables``, the kernel holds rows [offset/n, offset/n + size/n)
    of its shard, level-local rows [sid·size/n, (sid+1)·size/n), so the row
    base is offset/n − sid·size/n (mod 2^32) and a corner is the rank's iff
    row − offset/n < size/n, unsigned (``grid_common.cuh``: ``shard_owns``).
    """
    if spec.n_dims > MAX_DIMS:
        raise ValueError(
            f"the grid kernels cover at most {MAX_DIMS} dims, got {spec.n_dims}")
    sid, n = shard or (0, 1)
    out = np.zeros((spec.n_levels, LEVEL_FIELDS), np.uint32)
    live = set(live)
    for l, lv in enumerate(spec.levels):
        magic = ((2 ** 64 - 1) // lv.size + 1) % 2 ** 64
        first, n_rows = lv.offset // n, lv.size // n
        out[l, 0] = np.float32(lv.scale).view(np.uint32)
        out[l, 1] = lv.size
        out[l, 2] = (first - sid * n_rows) % 2 ** 32
        out[l, 3] = int(lv.use_hash)
        out[l, 4] = int(l in live)
        out[l, 5] = sum(1 << d for d, m in enumerate(lv.stride_mask) if m)
        out[l, 6:6 + spec.n_dims] = lv.strides
        out[l, 13] = magic & 0xFFFFFFFF
        out[l, 14] = magic >> 32
        out[l, 15] = first
        out[l, 16] = n_rows
    return out.view(np.int32)


def check_table_size(spec: GridSpec, flat: torch.Tensor, n_shards: int = 1) -> None:
    """The table has the spec's size, or a shard's (``n_shards`` > 1)."""
    want = spec.n_params // n_shards
    if flat.numel() != want:
        # A wrong-size table (a stale checkpoint after a spec change) would
        # read out of range in the kernel, where jnp.take clamps.
        shard = f" / {n_shards} shards" if n_shards > 1 else ""
        raise ValueError(
            f"table has {flat.numel()} elements but the grid spec needs "
            f"{want} ({spec.n_entries} rows × "
            f"{spec.n_features_per_level} features{shard})")


# -- model-parallel (row-sharded) tables (tcnn_tpu/ops/grid_ops.py:254-445) --
#
# Each grid table can be row-sharded over a process group in a block-cyclic
# layout: every level splits into n equal row blocks, and rank i holds
# block i of every level (``block_cyclic_perm`` maps the canonical flat
# layout to this one).  Under ``sharded_tables`` a grid gathers its group's
# batch, runs its kernels in shard mode on the local shard (a corner another
# rank owns contributes nothing: ``level_params``), and reduce-scatters the
# partial features, so that each rank gets its own samples' features; each
# table row is owned by exactly one rank, so the sum is the whole table's
# interpolation.


class TableSharding(NamedTuple):
    """The ``sharded_tables`` context: the process group (None: the default
    group) and its size."""
    group: Any
    n_shards: int


_TABLE_SHARDING: contextvars.ContextVar[Optional[TableSharding]] = \
    contextvars.ContextVar("tcnn_torch_table_sharding", default=None)


def table_sharding() -> Optional[TableSharding]:
    """The ``sharded_tables`` context in force (None outside one)."""
    return _TABLE_SHARDING.get()


def shardable_levels(spec: GridSpec, n_shards: int) -> bool:
    """True iff every level's row count divides ``n_shards`` ways
    (``tcnn_tpu/ops/grid_ops.py:273``).  Hash and dense levels are 8-row
    aligned, so 2, 4 and 8 shards qualify; Tiled levels are capped at
    base_resolution^D after the alignment and may not."""
    return all(lv.size % n_shards == 0 for lv in spec.levels)


def block_cyclic_perm(spec: GridSpec, n_shards: int) -> np.ndarray:
    """Flat-element permutation canonical → block-cyclic sharded layout
    (``tcnn_tpu/ops/grid_ops.py:283``): ``new_flat = old_flat[perm]``;
    shard i of the permuted table, elements [i·N/n, (i+1)·N/n), holds rows
    [i·size/n, (i+1)·size/n) of every level, concatenated in level order.
    ``np.argsort(perm)`` inverts it."""
    if not shardable_levels(spec, n_shards):
        raise ValueError(
            f"grid not block-cyclic shardable {n_shards} ways: level "
            f"sizes {[lv.size for lv in spec.levels]}")
    rows = np.concatenate([
        np.arange(lv.offset + m * (lv.size // n_shards),
                  lv.offset + (m + 1) * (lv.size // n_shards))
        for m in range(n_shards) for lv in spec.levels])
    f = spec.n_features_per_level
    return (rows[:, None] * f + np.arange(f)[None, :]).reshape(-1)


@contextlib.contextmanager
def sharded_tables(group, n_shards: int):
    """Grid tables are row-sharded ``n_shards`` ways over the process group
    ``group`` (``tcnn_tpu/ops/grid_ops.py:305-328``, where the group is a
    mesh axis).

    Under the context, ``grid_encode`` expects its table to be this rank's
    block-cyclic shard (``block_cyclic_perm``) and its batch to be this
    rank's slice of the group's batch: it all-gathers the batch,
    interpolates the rows it owns for all of it and reduce-scatters the
    partial features, so each rank gets its own samples' features.  A
    full-size table under the context is a grid left replicated and takes
    the ordinary path.

    Gradient convention: the table gradient of a rank is the sum over the
    group's ranks of their local losses' cotangents (the all-gather's
    transpose), i.e. that of Σ_ranks loss_rank; divide by ``n_shards`` for
    the group-mean loss, as ``HybridParallel``'s step does.
    """
    token = _TABLE_SHARDING.set(TableSharding(group, int(n_shards)))
    try:
        yield
    finally:
        _TABLE_SHARDING.reset(token)


def _engine_will_use(t: torch.Tensor) -> bool:
    """Whether the backward pass now running uses a gradient for ``t``
    (the table or x).

    ``ctx.needs_input_grad`` says only that ``t`` requires one: under
    ``torch.autograd.grad(y, x)`` (``Module.input_gradient``, the first
    derivative of an eikonal step) the table's gradient would be computed
    and thrown away, and under ``torch.autograd.grad(loss, params)`` (the
    parameter pass of an eikonal or curvature step) x's.  The engine knows
    which nodes it will run; PyTorch exposes that only through the private
    ``torch._C._will_engine_execute_node`` (the query behind
    ``torch.autograd.graph.register_multi_grad_hook``), pinned by
    ``tests/test_torch_second_order.py::test_engine_node_query_pinned``.
    It refuses a leaf under ``autograd.grad``, so ``grid_encode`` hands the
    functions views of the table and of an x that requires a gradient,
    never the leaves themselves."""
    if t.grad_fn is None:   # a leaf: cannot be asked, assume the gradient is used
        return True
    return torch._C._will_engine_execute_node(t.grad_fn)


def _refuse_forward_mode(spec: GridSpec) -> None:
    """Stochastic interpolation stays reverse-only, as in the JAX package
    (``tcnn_tpu/ops/grid_ops.py:1262-1276`` re-raises there; pinned by
    ``tests/test_grid.py::TestForwardMode::test_stochastic_stays_reverse_only``):
    its table gradient scatters with other weights than the forward's,
    which a tangent of the forward would not carry."""
    if spec.stochastic_interpolation:
        raise NotImplementedError(
            "forward-mode differentiation (jvp) of a grid with stochastic interpolation: "
            "it is reverse-only, as in the JAX package")


def _kernel_table(t: torch.Tensor) -> torch.Tensor:
    """A table tangent or cotangent as the grid kernels read tables:
    contiguous and 16-byte aligned."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _table_gradient(spec: GridSpec, flat: torch.Tensor, x: torch.Tensor, dcols: torch.Tensor,
                    live, frac, shard, sortseg: bool) -> torch.Tensor:
    """The first-order table gradient of both call sites
    (``GridEncodeFunction.backward`` without a graph,
    ``GridEncodeBackwardFunction.forward``): the ``sortseg`` route
    (``ops/sort_scatter.py``, kernels SK and SS; the JAX package's branch at
    ``tcnn_tpu/ops/grid_ops.py:962-977``) where ``sortseg``, else kernel GB."""
    if sortseg:
        from .sort_scatter import grid_table_gradient

        return grid_table_gradient(spec, flat, x, dcols, live, level_frac=frac, shard=shard)
    from .cuda.grid_encode import grid_encode_bwd

    return grid_encode_bwd(spec, flat, x, dcols, live, level_frac=frac, shard=shard)


class GridEncodeFunction(torch.autograd.Function):
    """The grid encoding with its gradients, the counterpart of
    ``_grid_interpolate``'s custom VJP (``tcnn_tpu/ops/grid_ops.py:917-1122``).

    Forward: kernel G (CUDA) or its plain version (CPU).  It saves ``x``
    and the table, not the (L·C, B) corner indices: the backward
    recomputes them, as the forward kernel does.  Backward: kernel GB for
    the table gradient, which accumulates in fp32 and returns the gradient
    in the table's dtype, cast once (grid_ops.py:1099-1102), and kernel GI
    for the input gradient (JAX's ``dws`` carried to x), only when x needs
    one.  Autograd's backward of ``GridEncoding``'s ``table.to(bfloat16)``
    then brings a bf16 gradient to the fp32 master, as in JAX; autograd
    would instead scatter-add the bf16 gradient of ``table2d[idx]`` in
    bf16.  Dead levels (static ``max_level``) get zero gradient, and so do
    the (sample, level) pairs that the per-sample mask ``frac`` drops (its
    (B,) level fractions go to every kernel, forward and backward).  Under
    ``create_graph`` the backward is ``GridEncodeBackwardFunction``, so the
    gradients can be differentiated once more.

    ``TCNN_TPU_SCATTER=sortseg``, read at each backward as the JAX package
    reads it, takes the table gradient through the sort-and-segment-sum
    route (kernels SK and SS, ``ops/sort_scatter.py``), whose fp32 sums run
    in a fixed order: the same inputs give the same bits, which GB's
    atomics do not.  It covers what JAX's branch covers, this first-order
    gradient; the table gradients of the second and third order (GG, GT)
    and of forward mode (``jvp``) keep their kernels.  A step captured in a
    CUDA graph (``Trainer.make_training_loop``) keeps the route it was
    captured with.

    ``torch.func``: the transform, not a failed launch, picks the route.
    Forward mode (``jvp``) is what the JAX package computes in jnp, outside
    any Pallas kernel (its fallback under a forward-mode trace,
    ``tcnn_tpu/ops/grid_ops.py:1262-1276``); both of its terms are linear
    in the table and run as kernels here: the table tangent through kernel
    G with the tangent as the table (fp32, SoA), and the input tangent,
    Σ_c (∇_x w_c · t_x) table[row_c], as kernel GG's d_dcols with ddx = t_x
    (``GridBwdBwdFunction``).  Their fp32 sum is cast to the table's dtype,
    as the primal is.  Stochastic interpolation raises.  ``vmap``
    (``func_rules``): a vmapped x folds into the batch, one launch; a
    vmapped table takes a launch per entry.
    """

    @staticmethod
    def forward(flat, x, spec, live, soa, frac, shard=None):
        from .cuda.grid_encode import grid_encode_fwd

        return grid_encode_fwd(spec, _kernel_table(flat), x, live, soa=soa, level_frac=frac,
                               shard=shard)

    @staticmethod
    def setup_context(ctx, inputs, output):
        flat, x, spec, live, soa, frac, *shard = inputs
        ctx.set_materialize_grads(False)   # no gradient in, no kernel launched
        ctx.spec, ctx.live, ctx.soa = spec, live, soa
        ctx.shard = shard[0] if shard else None
        ctx.save_for_backward(flat, x, frac)
        ctx.save_for_forward(flat, x, frac)

    @staticmethod
    def backward(ctx, dout):
        from .cuda.grid_encode import grid_encode_bwd_input
        from .sort_scatter import sortseg_selected

        if dout is None:
            return None, None, None, None, None, None, None
        flat, x, frac = ctx.saved_tensors
        dcols = dout if ctx.soa else dout.t()
        need_table = ctx.needs_input_grad[0] and _engine_will_use(flat)
        need_x = ctx.needs_input_grad[1] and _engine_will_use(x)
        sortseg = sortseg_selected()
        if torch.is_grad_enabled():
            dflat, dx = GridEncodeBackwardFunction.apply(flat, x, dcols, ctx.spec, ctx.live,
                                                         need_table, need_x, frac, ctx.shard,
                                                         sortseg)
        else:
            dflat = (_table_gradient(ctx.spec, flat, x, dcols, ctx.live, frac, ctx.shard,
                                     sortseg) if need_table else None)
            dx = (grid_encode_bwd_input(ctx.spec, flat, x, dcols, ctx.live, level_frac=frac,
                                        shard=ctx.shard) if need_x else None)
        return dflat, dx, None, None, None, None, None

    @staticmethod
    def jvp(ctx, t_flat, t_x, *_):
        flat, x, frac = ctx.saved_tensors
        spec, live = ctx.spec, ctx.live
        _refuse_forward_mode(spec)
        t = None
        if t_flat is not None:
            t = GridEncodeFunction.apply(t_flat.float(), x, spec, live, True, frac)
        if t_x is not None:
            tx = GridBwdBwdFunction.apply(flat, x, None, t_x, spec, live, True, False, False,
                                          frac)[0]
            t = tx if t is None else t + tx
        if t is None:
            t = torch.zeros((spec.n_output_dims, x.shape[0]), device=x.device)
        t = t.to(flat.dtype)
        return t if ctx.soa else t.t()

    @staticmethod
    def vmap(info, in_dims, flat, x, spec, live, soa, frac, shard=None):
        d_flat, d_x, *_, d_frac = in_dims[:6]
        if d_flat is not None:
            return func_rules.loop(GridEncodeFunction, info, in_dims[:6],
                                   (flat, x, spec, live, soa, frac))
        n = info.batch_size
        out = GridEncodeFunction.apply(flat, func_rules.fold(x, d_x, n, 0), spec, live, soa,
                                       func_rules.fold(frac, d_frac, n, 0))
        return func_rules.unfold(out, n, 1 if soa else 0), 1 if soa else 0


class GridEncodeBackwardFunction(torch.autograd.Function):
    """The grid's first-order backward as a differentiable function,
    ``(flat, x, dcols) → (dflat, dx)``: the reference bindings' two-Function
    pattern (SURVEY.md §3.4, modules.py:107-160).

    Forward: kernel GB for dflat (the ``sortseg`` route, kernels SK and SS,
    where ``sortseg``: ``GridEncodeFunction.backward`` passes it for the
    first-order gradient; every other caller, a higher derivative or
    ``jvp``, keeps GB) and kernel GI for dx, each only where asked.
    Backward, from the cotangents (ct_dflat, ct_dx), every block
    JAX's autodiff gives:
      * ct_dx through kernel GG (d dcols, d x and the table gradient of
        the input gradient, the transpose of JAX's corner re-gather,
        grid_ops.py:1110-1111), through ``GridBwdBwdFunction``;
      * ct_dflat through kernel G with ct_dflat as the table (d dcols) and
        kernel GI with ct_dflat as the table (d x): ``_scatter_weighted_bwd``'s
        math (scatter.py:528-550).
    dflat does not depend on the table.  Under stochastic interpolation
    dflat scatters with one-hot weights, comparisons of x: ct_dflat's d
    dcols is its gather at each (level, sample)'s one corner (kernel G's
    stochastic gather, ``StochasticGatherFunction``) and its d x is zero,
    as JAX's ``ws_bwd`` gives.  Under a per-sample level mask every kernel
    takes the fractions: a masked (sample, level) contributes nothing.
    Under ``create_graph`` these launches go through the functions'
    ``apply``, so a third derivative differentiates them
    (``GridBwdBwdFunction``'s backward).

    ``torch.func``: ``jvp`` is the tangent of (dflat, dx) from those of
    (flat, x, dcols), the same blocks forward (JAX forms them by autodiff of
    jnp code): t_dflat = GB(t_dcols) + GG's d_flat at ddx = t_x;
    t_dx = GI(t_flat as the table) + GI(t_dcols) + GG's d_x at ddx = t_x,
    every term a kernel.  This is the grid's part of a Hessian by
    ``jacfwd(grad)``.  ``vmap``: a vmapped x or dcols folds into the batch
    where dx alone is asked for; dflat sums over the samples, so with it (or
    a vmapped table) a launch per entry.
    """

    @staticmethod
    def forward(flat, x, dcols, spec, live, need_table, need_x, frac, shard=None,
                sortseg=False):
        from .cuda.grid_encode import grid_encode_bwd_input

        dflat = (_table_gradient(spec, flat, x, dcols, live, frac, shard, sortseg)
                 if need_table else None)
        dx = (grid_encode_bwd_input(spec, _kernel_table(flat), x, dcols, live, level_frac=frac,
                                    shard=shard) if need_x else None)
        return dflat, dx

    @staticmethod
    def setup_context(ctx, inputs, output):
        flat, x, dcols, spec, live, need_table, need_x, frac, *shard = inputs
        ctx.set_materialize_grads(False)
        ctx.spec, ctx.live, ctx.need = spec, live, (need_table, need_x)
        ctx.shard = shard[0] if shard else None   # the route (shard[1:]) serves forward alone
        ctx.save_for_backward(flat, x, dcols, frac)
        ctx.save_for_forward(flat, x, dcols, frac)

    @staticmethod
    def backward(ctx, ct_dflat, ct_dx):
        flat, x, dcols, frac = ctx.saved_tensors
        spec, live, shard = ctx.spec, ctx.live, ctx.shard
        need_dcols = ctx.needs_input_grad[2]
        need_x = ctx.needs_input_grad[1] and _engine_will_use(x)
        need_table = ctx.needs_input_grad[0] and _engine_will_use(flat)
        d_flat = d_x = d_dcols = None
        if ct_dx is not None:
            d_dcols, d_x, d_flat = _call(GridBwdBwdFunction, flat, x, dcols, ct_dx, spec, live,
                                         need_dcols, need_x, need_table, frac, shard)
        if ct_dflat is not None:
            u = _kernel_table(ct_dflat)
            if need_dcols:
                if spec.stochastic_interpolation:
                    du = _call(StochasticGatherFunction, u, x, spec, live, frac)
                else:
                    du = _call(GridEncodeFunction, u, x, spec, live, True, frac, shard).float()
                d_dcols = du if d_dcols is None else d_dcols + du
            # under stochastic interpolation dflat's weights are comparisons of
            # x (JAX's ws_bwd): no term in x
            if need_x and not spec.stochastic_interpolation:
                du = _call(GridEncodeBackwardFunction, u, x, dcols, spec, live, False, True, frac,
                           shard)[1]
                d_x = du if d_x is None else d_x + du
        if d_dcols is not None:
            d_dcols = d_dcols.to(dcols.dtype)
        return d_flat, d_x, d_dcols, None, None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, t_flat, t_x, t_dcols, *_):
        flat, x, dcols, frac = ctx.saved_tensors
        spec, live = ctx.spec, ctx.live
        need_table, need_x = ctx.need
        _refuse_forward_mode(spec)
        t_dflat = t_dx = None
        if t_dcols is not None:
            t_dflat, t_dx = GridEncodeBackwardFunction.apply(flat, x, t_dcols, spec, live,
                                                             need_table, need_x, frac)
        if t_x is not None:
            _, gx, gflat = GridBwdBwdFunction.apply(flat, x, dcols, t_x, spec, live, False,
                                                    need_x, need_table, frac)
            t_dflat = gflat if t_dflat is None else t_dflat + gflat
            t_dx = gx if t_dx is None else t_dx + gx
        if t_flat is not None and need_x:
            gi = GridEncodeBackwardFunction.apply(t_flat, x, dcols, spec, live, False, True,
                                                  frac)[1]
            t_dx = gi if t_dx is None else t_dx + gi
        if need_table and t_dflat is None:
            t_dflat = torch.zeros_like(flat)
        if need_x and t_dx is None:
            t_dx = torch.zeros(x.shape, device=x.device)
        return t_dflat, t_dx

    @staticmethod
    def vmap(info, in_dims, flat, x, dcols, spec, live, need_table, need_x, frac, shard=None,
             sortseg=False):
        in_dims = in_dims[:8]
        args = (flat, x, dcols, spec, live, need_table, need_x, frac)
        if in_dims[0] is not None or need_table:
            return func_rules.loop(GridEncodeBackwardFunction, info, in_dims + (None, None),
                                   args + (None, sortseg))
        n = info.batch_size
        _, dx = GridEncodeBackwardFunction.apply(
            flat, func_rules.fold(x, in_dims[1], n, 0), func_rules.fold(dcols, in_dims[2], n, 1),
            spec, live, False, need_x, func_rules.fold(frac, in_dims[7], n, 0))
        return (None, func_rules.unfold(dx, n, 0)), (None, 0 if need_x else None)


def _call(fn, *args):
    """``fn.apply(*args)`` where a backward records its graph (a higher
    derivative will differentiate it), else ``fn.forward(*args)``: the
    kernels alone, no graph."""
    return (fn.apply if torch.is_grad_enabled() else fn.forward)(*args)


def _add(a, b):
    return b if a is None else a if b is None else a + b


def _zero_dcols(spec: GridSpec, x: torch.Tensor) -> torch.Tensor:
    """An (L·F, B) dcols of zeros, for a GG or GT output that does not
    depend on it (a view: nothing is allocated per sample)."""
    return torch.zeros(1, device=x.device).expand(spec.n_output_dims, x.shape[0])


class GridBwdBwdFunction(torch.autograd.Function):
    """Kernel GG as a function of (flat, x, dcols, ddx): ``(d_dcols, d_x,
    d_flat)``, the gradients of ⟨dx, ddx⟩ (dx the grid's input gradient,
    kernel GI) in dcols, x and the table, each only where asked
    (``grid_encode_bwd_bwd``, one launch: GG adds d_flat itself, on kernel
    GB's work plan).  The second order of ``GridEncodeBackwardFunction``
    calls it (through ``apply`` under ``create_graph``); forward mode calls
    it through ``apply`` (d_dcols at ddx = t_x is the grid's input tangent),
    so that ``vmap`` finds its rule: a vmapped x, dcols or ddx folds into
    the batch where d_flat is not asked for, else a launch per entry.
    ``dcols`` None reads as zeros (d_dcols does not depend on it).

    Third derivatives (JAX's autodiff of the jnp backward of
    ``_grid_interpolate``, ``tcnn_tpu/ops/grid_ops.py:917-1122``): the
    backward, from the cotangents (α, β, γ) of (d_dcols, d_x, d_flat), with
    T the table, δ = dcols, v = ddx, is these launches, each where its
    cotangent and input ask for it:
      * T: GG's d_flat at (dcols α, ddx v) + GT's table block;
      * dcols: GG's d_dcols at (table γ, ddx v) + GT's d_dcols;
      * ddx: GI(T, α) + GG's d_x at (dcols δ, ddx β) + GI(γ, δ);
      * x: GG's d_x at (dcols α, ddx v) and at (table γ, dcols δ, ddx v) +
        GT's d_x;
    GT (``GridThirdFunction``) at (T, δ, v, β): the terms in
    u_c = βᵀ ∇²w_c v and ∇³w_c, which no other kernel computes.  ``jvp``
    runs the same blocks with the tangents (t_T, t_x, t_δ, t_v) in place of
    the cotangents: GG at (t_T, δ, v), (T, t_δ, v) and (T, δ, t_v), and GT
    with β = t_x (∇³w is symmetric).  Under a per-sample mask every launch
    takes the fractions; with ``shard`` every launch runs in shard mode.
    Stochastic interpolation keeps forward mode refused, as in JAX."""

    @staticmethod
    def forward(flat, x, dcols, ddx, spec, live, need_dcols, need_x, need_table, frac,
                shard=None):
        from .cuda.grid_encode import grid_encode_bwd_bwd

        if dcols is None:
            dcols = _zero_dcols(spec, x)
        return tuple(grid_encode_bwd_bwd(spec, flat, x, dcols, ddx, live, need_dcols=need_dcols,
                                         need_x=need_x, need_table=need_table, level_frac=frac,
                                         shard=shard))

    @staticmethod
    def setup_context(ctx, inputs, output):
        flat, x, dcols, ddx, spec, live, need_dcols, need_x, need_table, frac, *shard = inputs
        ctx.set_materialize_grads(False)
        ctx.spec, ctx.live, ctx.need = spec, live, (need_dcols, need_x, need_table)
        ctx.shard = shard[0] if shard else None
        ctx.save_for_backward(flat, x, dcols, ddx, frac)
        ctx.save_for_forward(flat, x, dcols, ddx, frac)

    @staticmethod
    def backward(ctx, ct_ddcols, ct_dx, ct_dflat):
        flat, x, dcols, v, frac = ctx.saved_tensors
        spec, live, shard = ctx.spec, ctx.live, ctx.shard
        need_dcols, need_v = ctx.needs_input_grad[2:4]
        need_x = ctx.needs_input_grad[1] and _engine_will_use(x)
        need_table = ctx.needs_input_grad[0] and _engine_will_use(flat)
        need_dcols = need_dcols and dcols is not None
        if dcols is None:
            dcols = _zero_dcols(spec, x)
        g_flat = g_x = g_dcols = g_v = None
        if ct_ddcols is not None:   # α: d_dcols = Σ_c w'_c T_c
            a = ct_ddcols.float()
            if need_table or need_x:
                _, gx, gt = _call(GridBwdBwdFunction, flat, x, a, v, spec, live, False, need_x,
                                  need_table, frac, shard)
                g_flat, g_x = _add(g_flat, gt), _add(g_x, gx)
            if need_v:
                g_v = _add(g_v, _call(GridEncodeBackwardFunction, flat, x, a, spec, live, False,
                                      True, frac, shard)[1])
        if ct_dx is not None:       # β: d_x = Σ_c ∇²w_c v ⟨T_c, δ⟩
            if need_table or need_dcols or need_x:
                gd, gx, gt = _call(GridThirdFunction, flat, x, dcols, v, ct_dx, spec, live,
                                   need_dcols, need_x, need_table, frac, shard)
                g_flat, g_x, g_dcols = _add(g_flat, gt), _add(g_x, gx), _add(g_dcols, gd)
            if need_v:
                g_v = _add(g_v, _call(GridBwdBwdFunction, flat, x, dcols, ct_dx, spec, live,
                                      False, True, False, frac, shard)[1])
        if ct_dflat is not None:    # γ: d_flat[row_c] += w'_c δ
            gam = _kernel_table(ct_dflat)
            if need_dcols or need_x:
                gd, gx, _ = _call(GridBwdBwdFunction, gam, x, dcols, v, spec, live, need_dcols,
                                  need_x, False, frac, shard)
                g_x, g_dcols = _add(g_x, gx), _add(g_dcols, gd)
            if need_v:
                g_v = _add(g_v, _call(GridEncodeBackwardFunction, gam, x, dcols, spec, live,
                                      False, True, frac, shard)[1])
        if g_dcols is not None:
            g_dcols = g_dcols.to(dcols.dtype)
        if g_flat is not None:
            g_flat = g_flat.to(flat.dtype)
        if g_v is not None:
            g_v = g_v.to(v.dtype)
        return g_flat, g_x, g_dcols, g_v, None, None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, t_flat, t_x, t_dcols, t_v, *_):
        flat, x, dcols, v, frac = ctx.saved_tensors
        spec, live = ctx.spec, ctx.live
        need_dcols, need_x, need_table = ctx.need
        _refuse_forward_mode(spec)
        fn = GridBwdBwdFunction
        out = [None, None, None]

        def add(terms):
            for i, t in enumerate(terms):
                out[i] = _add(out[i], t)

        if t_v is not None:
            add(fn.apply(flat, x, dcols, t_v, spec, live, need_dcols, need_x, need_table, frac))
        if t_flat is not None and (need_dcols or need_x):
            add(fn.apply(_kernel_table(t_flat), x, dcols, v, spec, live, need_dcols, need_x,
                         False, frac))
        if t_dcols is not None and (need_x or need_table):
            add(fn.apply(flat, x, t_dcols, v, spec, live, False, need_x, need_table, frac))
        if t_x is not None:
            d = dcols if dcols is not None else _zero_dcols(spec, x)
            add(GridThirdFunction.apply(flat, x, d, v, t_x, spec, live, need_dcols, need_x,
                                        need_table, frac))
        shapes = ((spec.n_output_dims, x.shape[0]), x.shape, flat.shape)
        dtypes = (torch.float32, torch.float32, flat.dtype)
        return tuple(
            None if not need else
            (o if o is not None else torch.zeros(shape, device=x.device)).to(dt)
            for o, need, shape, dt in zip(out, ctx.need, shapes, dtypes))

    @staticmethod
    def vmap(info, in_dims, flat, x, dcols, ddx, spec, live, need_dcols, need_x, need_table,
             frac, shard=None):
        in_dims = in_dims[:10]
        args = (flat, x, dcols, ddx, spec, live, need_dcols, need_x, need_table, frac)
        if in_dims[0] is not None or need_table:
            return func_rules.loop(GridBwdBwdFunction, info, in_dims, args)
        n = info.batch_size
        fold = func_rules.fold
        d_dcols, d_x, _ = GridBwdBwdFunction.apply(
            flat, fold(x, in_dims[1], n, 0), fold(dcols, in_dims[2], n, 1),
            fold(ddx, in_dims[3], n, 0), spec, live, need_dcols, need_x, False,
            fold(frac, in_dims[9], n, 0))
        return ((func_rules.unfold(d_dcols, n, 1), func_rules.unfold(d_x, n, 0), None),
                (1 if need_dcols else None, 0 if need_x else None, None))


def _refuse_fourth_order():
    raise NotImplementedError(
        "fourth derivatives of the grid encoding are not computed: kernel GT's own "
        "derivative is not written (ROADMAP.md, Not queued)")


class GridThirdFunction(torch.autograd.Function):
    """Kernel GT as a function of (flat, x, dcols, ddx, ct_dx):
    ``(d_dcols, d_x, d_flat)`` (``grid_encode_third``), the blocks of
    ``GridBwdBwdFunction``'s backward in u_c = βᵀ ∇²w_c v and ∇³w_c (β =
    ``ct_dx``, v = ``ddx``), each only where asked.  Its own derivative
    would be a fourth derivative of the grid and raises.  ``vmap``: as
    ``GridBwdBwdFunction``'s, a vmapped x, dcols, ddx or ct_dx folds into
    the batch where d_flat is not asked for, else a launch per entry."""

    @staticmethod
    def forward(flat, x, dcols, ddx, ct_dx, spec, live, need_dcols, need_x, need_table, frac,
                shard=None):
        from .cuda.grid_encode import grid_encode_third

        return tuple(grid_encode_third(spec, flat, x, dcols, ddx, ct_dx, live,
                                       need_dcols=need_dcols, need_x=need_x,
                                       need_table=need_table, level_frac=frac, shard=shard))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *cts):
        _refuse_fourth_order()

    @staticmethod
    def jvp(ctx, *tangents):
        _refuse_fourth_order()

    @staticmethod
    def vmap(info, in_dims, flat, x, dcols, ddx, ct_dx, spec, live, need_dcols, need_x,
             need_table, frac, shard=None):
        in_dims = in_dims[:11]
        args = (flat, x, dcols, ddx, ct_dx, spec, live, need_dcols, need_x, need_table, frac)
        if in_dims[0] is not None or need_table:
            return func_rules.loop(GridThirdFunction, info, in_dims, args)
        n = info.batch_size
        fold = func_rules.fold
        d_dcols, d_x, _ = GridThirdFunction.apply(
            flat, fold(x, in_dims[1], n, 0), fold(dcols, in_dims[2], n, 1),
            fold(ddx, in_dims[3], n, 0), fold(ct_dx, in_dims[4], n, 0), spec, live,
            need_dcols, need_x, False, fold(frac, in_dims[10], n, 0))
        return ((func_rules.unfold(d_dcols, n, 1), func_rules.unfold(d_x, n, 0), None),
                (1 if need_dcols else None, 0 if need_x else None, None))


class StochasticGatherFunction(torch.autograd.Function):
    """The derivative of a loss on a stochastic-interpolation table
    gradient (kernel GB's, which puts each (level, sample)'s cotangent on
    one corner) in that cotangent: (L·F, B) fp32, the table-shaped
    cotangent ``u`` gathered at each (level, sample)'s one-hot corner,
    kernel G's run-time-D instance taking the uniforms
    (``grid_encode_fwd(stochastic=True)``).  It is linear in ``u`` and its
    transpose is GB's stochastic scatter (``GridEncodeBackwardFunction``,
    so a higher derivative goes on through it); x gets none: JAX's
    ``ws_bwd`` are comparisons (``tcnn_tpu/ops/grid_ops.py:523-535``)."""

    @staticmethod
    def forward(u, x, spec, live, frac):
        from .cuda.grid_encode import grid_encode_fwd

        return grid_encode_fwd(spec, u, x, live, soa=True, level_frac=frac,
                               stochastic=True).float()

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, x, spec, live, frac = inputs
        ctx.set_materialize_grads(False)
        ctx.spec, ctx.live = spec, live
        ctx.save_for_backward(u, x, frac)

    @staticmethod
    def backward(ctx, g):
        u, x, frac = ctx.saved_tensors
        du = None
        if g is not None and ctx.needs_input_grad[0]:
            du = _call(GridEncodeBackwardFunction, u, x, g, ctx.spec, ctx.live, True, False,
                       frac)[0]
        return du, None, None, None, None


def grid_encode(spec: GridSpec, table: torch.Tensor, x: torch.Tensor,
                max_level: Optional[int] = None, soa: bool = False,
                max_level_per_element: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward grid encoding (``tcnn_tpu/ops/grid_ops.py:1125-1297``).

    table: flat (n_entries·F,) or (n_entries, F), float32 or bfloat16.
    x: (B, D) coordinates.  Levels at or above the static ``max_level``
    emit zeros.  ``max_level_per_element``: optional (B,) level fractions,
    the coarse-to-fine mask of ``level_mask`` (sample b keeps level l iff
    l < frac[b]·n_levels + 1e-3), composed with ``max_level``; a masked
    (sample, level) emits zeros and gets zero table and input gradients.
    Returns (B, L·F) features, or (L·F, B) with ``soa``,
    in the table's dtype (JAX casts the columns to ``table.dtype``).

    A CUDA tensor goes through the grid kernels, forward, backward and
    second order; a CPU tensor through their plain versions.  Gradients
    flow to the table and, where x requires one, to x; both can be
    differentiated once more (``create_graph``).

    Inside ``sharded_tables(group, n)`` with a table of 1/n of the spec's
    size (``tcnn_tpu/ops/grid_ops.py:1180-1233``): all-gathers x (and the
    level fractions) over the group, encodes the gathered batch on the
    local block-cyclic shard with the kernels in shard mode, and
    reduce-scatters the fp32 partial features (cast to the table's dtype
    after the sum, as JAX casts its psum_scatter), so each rank gets its own
    rows.  The backward
    all-gathers the output gradient: the table gradient (kernel GB) is the
    sum of every rank's cotangents; dx (kernel GI's partial) is
    reduce-scattered.  The collectives are their own transposes
    (``collectives``), so the second order (the eikonal loss) goes through
    them.  Stochastic interpolation and ``torch.func`` transforms raise
    there.  A full-size table under the context takes the ordinary path.
    """
    if x.ndim != 2 or x.shape[1] != spec.n_dims:
        raise ValueError(f"expected (B, {spec.n_dims}) input, got {tuple(x.shape)}")
    flat = table.reshape(-1)
    ctx = _TABLE_SHARDING.get()
    sharded = ctx is not None and ctx.n_shards > 1 and flat.numel() != spec.n_params
    check_table_size(spec, flat, ctx.n_shards if sharded else 1)
    frac = max_level_per_element
    if frac is not None:
        frac = frac.reshape(-1)
        if frac.shape[0] != x.shape[0]:
            raise ValueError(f"max_level_per_element has {frac.shape[0]} entries "
                             f"for {x.shape[0]} samples")
        frac = frac.to(device=x.device, dtype=torch.float32).contiguous()
    live = tuple(live_levels(spec, max_level))
    if x.requires_grad:   # a view the engine can be asked about (_engine_will_use)
        x = x.view_as(x)
    if not sharded:
        return GridEncodeFunction.apply(flat, x, spec, live, soa, frac)
    if spec.stochastic_interpolation:
        raise NotImplementedError(
            "sharded_tables does not support stochastic_interpolation "
            "(the backward scatter weights differ from the forward's)")
    if torch._C._are_functorch_transforms_active():
        raise NotImplementedError(
            "torch.func transforms do not pass through a row-sharded grid table's "
            "collectives; gather the table (HybridParallel.gather_state) first")
    if not shardable_levels(spec, ctx.n_shards):
        raise ValueError(
            f"sharded_tables({ctx.n_shards}): level sizes {[lv.size for lv in spec.levels]} "
            f"do not all divide {ctx.n_shards} ways")
    group = ctx.group
    shard = (collectives.rank(group), ctx.n_shards)
    if collectives.world(group) != ctx.n_shards:
        raise ValueError(f"sharded_tables: {ctx.n_shards} shards on a group of "
                         f"{collectives.world(group)} ranks")
    x_all = collectives.all_gather(x, group)
    frac_all = None if frac is None else collectives.all_gather(frac, group)
    cols = GridEncodeFunction.apply(flat, x_all, spec, live, soa, frac_all, shard)
    return collectives.reduce_scatter(cols, group, dim=1 if soa else 0).to(flat.dtype)

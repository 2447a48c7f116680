"""HashType.Rng: the reference's pcg32 skip-ahead grid hash.

PyTorch counterpart of ``tcnn_tpu/ops/pcg32_hash.py`` (copied, not
imported).  Reference semantics (common_device.h:678-691 ``rng_hash`` and
pcg32.h): pack the D grid coordinates into a 64-bit ``step`` (coordinate i
XORed in at bit i·(64/D)), construct ``pcg32(1337)`` (stream 1),
``advance(step)`` by the LCG jump-ahead, and return ``next_uint()``.

``rng_hash_host`` is the exact host model in Python integers, the oracle
of the tests.  ``rng_hash`` is the plain version in torch int64: a product
of two int64 values wraps mod 2^64, as the uint64 arithmetic of the
reference does, so the state and the jump-ahead's accumulators are held as
int64 bit patterns.  A right shift of an int64 is arithmetic, so every
shift of a 64-bit value masks away the sign bits it brings in
(``_shr``).  The 64 (multiplier, increment) pairs of the jump-ahead depend
only on the stream, never on the data (``advance_constants``); kernels G,
GB, GI and GG hold the same pairs in constant memory
(``csrc/grid_common.cuh``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

PCG32_MULT = 0x5851F42D4C957F2D
SEED = 1337
_M64 = (1 << 64) - 1


def pcg32_state_after_seed(initstate: int, initseq: int = 1) -> Tuple[int, int]:
    """(state, inc) after pcg32::seed (pcg32.h:53-59)."""
    inc = ((initseq << 1) | 1) & _M64
    state = inc   # next_uint() from state 0: state = 0·MULT + inc
    state = (state + initstate) & _M64
    state = (state * PCG32_MULT + inc) & _M64
    return state, inc


def pcg32_output(state: int) -> int:
    """next_uint()'s output function of the pre-bump state (pcg32.h:62-68)."""
    xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
    rot = state >> 59
    return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF


def pcg32_advanced_state(state: int, inc: int, delta: int) -> int:
    """state after advance(delta) (pcg32.h:145-166)."""
    cur_mult, cur_plus = PCG32_MULT, inc
    acc_mult, acc_plus = 1, 0
    delta &= _M64
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & _M64
            acc_plus = (acc_plus * cur_mult + cur_plus) & _M64
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
        delta >>= 1
    return (acc_mult * state + acc_plus) & _M64


def pack_step(pos_grid: Sequence[int]) -> int:
    """The 64-bit ``step``: coordinate i (as uint32) XORed in at bit i·(64/D)."""
    nbits = 64 // len(pos_grid)
    step = 0
    for i, p in enumerate(pos_grid):
        step ^= (int(p) & 0xFFFFFFFF) << (i * nbits)
    return step & _M64


def rng_hash_host(pos_grid: Sequence[int], seed: int = SEED) -> int:
    """The whole rng_hash in Python integers (the tests' oracle)."""
    state, inc = pcg32_state_after_seed(seed)
    return pcg32_output(pcg32_advanced_state(state, inc, pack_step(pos_grid)))


@functools.lru_cache(maxsize=None)
def advance_constants(seed: int = SEED) -> Tuple[Tuple[int, int], ...]:
    """The 64 (cur_mult, cur_plus) pairs of the jump-ahead loop, as uint64."""
    _, inc = pcg32_state_after_seed(seed)
    out = []
    cur_mult, cur_plus = PCG32_MULT, inc
    for _ in range(64):
        out.append((cur_mult, cur_plus))
        cur_plus = ((cur_mult + 1) * cur_plus) & _M64
        cur_mult = (cur_mult * cur_mult) & _M64
    return tuple(out)


def _i64(v: int) -> int:
    """A uint64 value as the int64 of the same bits."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _shr(v: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < k < 64."""
    return (v >> k) & ((1 << (64 - k)) - 1)


def rng_hash(coords: Sequence[torch.Tensor], seed: int = SEED) -> torch.Tensor:
    """rng_hash of per-dim uint32 coordinates held in int64 tensors of one
    shape; returns the uint32 hashes in int64, bit-exact to the reference."""
    d = len(coords)
    nbits = 64 // d
    step = torch.zeros_like(coords[0])
    for i, p in enumerate(coords):
        # (p << 63) of a coordinate with bit 0 set lands on the sign bit:
        # int64 shifts keep the low 64 bits, as uint64 does.
        step = step ^ ((p & 0xFFFFFFFF) << (i * nbits))
    state0, _ = pcg32_state_after_seed(seed)
    acc_mult = torch.ones_like(step)
    acc_plus = torch.zeros_like(step)
    for j, (cm, cp) in enumerate(advance_constants(seed)):
        bit = ((step >> j) & 1).bool()
        cm, cp = _i64(cm), _i64(cp)
        acc_mult = torch.where(bit, acc_mult * cm, acc_mult)
        acc_plus = torch.where(bit, acc_plus * cm + cp, acc_plus)
    s = acc_mult * _i64(state0) + acc_plus
    xorshifted = _shr(_shr(s, 18) ^ s, 27) & 0xFFFFFFFF
    rot = _shr(s, 59)
    return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & 0xFFFFFFFF

"""JAX's default random numbers, bit for bit: threefry2x32 and ``uniform``.

Stochastic interpolation (``grid_ops.stochastic_uniforms``) draws one
uniform per (level, sample) as the JAX package does,
``jax.random.uniform(jax.random.key(1337), (n_levels, B))``
(``tcnn_tpu/ops/grid_ops.py:524-535``), so that the port picks the same
corners as JAX in a real run.  This module repeats what JAX computes for
that call with its default settings (threefry2x32 keys,
``jax_threefry_partitionable`` on):

  * ``key(seed)`` holds the words (seed >> 32, seed & 0xFFFFFFFF);
  * element i of the row-major shape takes the counter (i >> 32, i & 0xFFFFFFFF)
    and its 32 random bits are the XOR of threefry2x32's two output words
    (``_threefry_random_bits_partitionable``);
  * ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
    and subtracts 1.

uint32 arithmetic in torch int64, masked to 32 bits after each step.
"""

from __future__ import annotations

from typing import Tuple

import torch

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _U32


def threefry2x32(key: Tuple[int, int], c0: torch.Tensor,
                 c1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 (20 rounds) of the counters (c0, c1), uint32 values in
    int64 tensors, under the key words ``key``."""
    ks = (key[0] & _U32, key[1] & _U32, (key[0] ^ key[1] ^ _PARITY) & _U32)
    x0 = (c0 + ks[0]) & _U32
    x1 = (c1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def random_bits(seed: int, n: int, device=None) -> torch.Tensor:
    """The 32 random bits of elements 0 .. n−1 of ``jax.random.bits(key(seed))``
    for a shape of n elements, as int64."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32((seed >> 32, seed & _U32), i >> 32, i & _U32)
    return b0 ^ b1


def uniform(seed: int, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.uniform(jax.random.key(seed), shape)``: float32 in [0, 1)."""
    n = 1
    for s in shape:
        n *= s
    bits = (random_bits(seed, n, device) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)

"""Common definitions: enums, dtype policy, constants.

PyTorch counterpart of ``tcnn_tpu/common.py``.  The enums and the hash
primes are copied, not imported: this package never imports the JAX
package (``tcnn_tpu/__init__.py`` pulls in jax).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

# Batch-size granularity of the reference (common.h:235; the JAX package's
# tcnn_tpu/common.py:25).  Not required: the kernels take ragged batches;
# the torch bindings pad every batch to a multiple of it, as the original's.
BATCH_SIZE_GRANULARITY = 256

# Hash primes of the reference's grid hashes (common_device.h:646-664).
PRIME_HASH_FACTORS = (
    1958374283, 2654435761, 805459861, 3674653429,
    2097192037, 1434869437, 2165219737,
)
COHERENT_PRIME_HASH_FACTORS = (
    1, 2654435761, 805459861, 3674653429,
    2097192037, 1434869437, 2165219737,
)
REVERSED_PRIME_HASH_FACTORS = tuple(reversed(PRIME_HASH_FACTORS))

MAX_N_GRID_LEVELS = 128  # grid_interface.h:84


class _FromString:
    @classmethod
    def from_string(cls, s: str):
        for a in cls:
            if a.value.lower() == s.lower():
                return a
        raise ValueError(f"Invalid {cls.__name__} name: {s}")


class Activation(_FromString, enum.Enum):
    NONE = "None"
    RELU = "ReLU"
    LEAKY_RELU = "LeakyReLU"
    EXPONENTIAL = "Exponential"
    SINE = "Sine"
    SIGMOID = "Sigmoid"
    SQUAREPLUS = "Squareplus"
    SOFTPLUS = "Softplus"
    TANH = "Tanh"


class GridType(_FromString, enum.Enum):
    HASH = "Hash"
    DENSE = "Dense"
    TILED = "Tiled"


class HashType(_FromString, enum.Enum):
    PRIME = "Prime"
    COHERENT_PRIME = "CoherentPrime"
    REVERSED_PRIME = "ReversedPrime"
    RNG = "Rng"
    # Like CoherentPrime, but dim 0 is ADDED after the XOR of the other
    # dims, so the two corners along dim 0 land on adjacent table rows.
    COHERENT_ADD = "CoherentAdd"


class InterpolationType(_FromString, enum.Enum):
    NEAREST = "Nearest"
    LINEAR = "Linear"
    SMOOTHSTEP = "Smoothstep"


class ReductionType(_FromString, enum.Enum):
    CONCATENATION = "Concatenation"
    SUM = "Sum"
    PRODUCT = "Product"


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: fp32 parameters, ``compute_dtype`` for
    the grid table copy and the MLP operands, ``output_dtype`` for what
    the user gets back."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x) -> torch.Tensor:
        """``x`` (a tensor, array or number) in ``compute_dtype``
        (``tcnn_tpu/common.py:137``); a tensor keeps its device."""
        return torch.as_tensor(x, dtype=self.compute_dtype)

    def cast_to_output(self, x) -> torch.Tensor:
        """``x`` in ``output_dtype`` (``tcnn_tpu/common.py:140``)."""
        return torch.as_tensor(x, dtype=self.output_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)


def default_policy() -> Policy:
    """The policy modules take when given none (``tcnn_tpu/common.py:150``)."""
    return DEFAULT_POLICY


def next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card: ``None`` means ``cuda``
    and raises where there is none.  The CPU runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tcnn_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        device = "cuda"
    return torch.device(device)

"""Build of the port's hand-written CUDA kernels (Hopper, sm_90a).

The sources live in ``tcnn_tpu_torch/csrc``.  They are compiled on first
use, never at import: the CPU-only tests import every module.  One call
to ``torch.utils.cpp_extension.load`` compiles all of them (ninja runs
one compiler per source, all at once) into ``build/tcnn_tpu_torch_kernels``
at the root of the checkout, a directory ``.gitignore`` lists.  Only
``bindings.cpp`` includes PyTorch's headers; the kernels have a plain C++
interface (``csrc/kernels.h``).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
SOURCES = ("bindings.cpp", "grid_encode.cu", "grid_encode_bwd.cu",
           "grid_encode_bwd_input.cu", "grid_encode_bwd_bwd.cu", "grid_encode_third.cu",
           "row_scatter.cu", "fused_mlp.cu", "fused_mlp_bwd.cu", "fused_mlp_wide.cu")
BUILD_DIR = _PKG.parent / "build" / "tcnn_tpu_torch_kernels"
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")


@functools.lru_cache(maxsize=None)
def kernels():
    """The compiled extension module; builds it on the first call."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device")
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)   # load() does not create it
    return load(
        name="tcnn_tpu_torch_kernels",
        sources=[str(CSRC / s) for s in SOURCES],
        extra_include_paths=[str(CSRC)],
        extra_cflags=["-O3"],
        extra_cuda_cflags=list(CUDA_FLAGS),
        build_directory=str(BUILD_DIR),
        verbose=False,
    )


def require_cuda_tensors(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device: the kernels take nothing else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")


"""Wrapper of kernel SR (``csrc/shampoo_root.cu``): Shampoo's preconditioner
roots, refreshed on the device on the steps that refresh them.

It replaces no TPU kernel.  The JAX package computes the roots with XLA's
``eigh`` under a ``lax.cond`` on the step counter, inside the jitted step
(``tcnn_tpu/optimizers/shampoo.py:140-141``, ``:166-176``, ``:43-50``).
SR does both in one launch for a list of preconditioners: it reads the
counter from device memory, returns at once unless ``refresh_due``, and
otherwise writes each root ``(sym(L)·(1 − s) + s·I)^(−1/4)`` in place, by a
cyclic Jacobi eigensolver (see the source).  Nothing is read back to the
host, so a step that calls it can be captured in a CUDA graph and replays
refresh on the right steps.

A CUDA counter launches the kernel; a CPU counter takes
``shampoo_refresh_roots_plain``: ``inverse_4th_root_psd`` (LAPACK's eigh)
under the same predicate.  The kernel's limits (matrices a launch, the
largest n, the sweep cap) live in ``csrc/kernels.h``; the binding splits a
longer list into launches and exports the cap as
``kernels().shampoo_root_max_sweeps``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...optimizers.shampoo import inverse_4th_root_psd, refresh_due
from . import kernels, require_cuda_tensors

def shampoo_refresh_roots_plain(step: torch.Tensor, mats: Sequence[torch.Tensor],
                                roots: Sequence[torch.Tensor], identity_strength: float) -> None:
    """Plain version of kernel SR: on a refresh step each root becomes
    ``inverse_4th_root_psd`` of its matrix; on any other step nothing
    changes.  Reads the counter (it is the CPU's)."""
    if bool(refresh_due(step)):
        for a, root in zip(mats, roots, strict=True):
            root.copy_(inverse_4th_root_psd(a, identity_strength))


def shampoo_refresh_roots(step: torch.Tensor, mats: Sequence[torch.Tensor],
                          roots: Sequence[torch.Tensor], identity_strength: float,
                          stats: Optional[torch.Tensor] = None,
                          max_sweeps: Optional[int] = None) -> None:
    """Kernel SR: see ``shampoo_refresh_roots_plain``.  ``step`` the
    optimizer's 0-d int32 counter (already counting this step); ``mats``
    square float32 contiguous matrices, ``roots`` as many of their shapes,
    written in place, all on the counter's device.  ``stats``, an optional
    (len(mats), 2) int32 tensor there, receives each refreshed matrix's
    Jacobi sweeps and the rotations it applied (untouched on other steps).
    ``max_sweeps`` lowers the kernel's cap on sweeps (a control that stops
    Jacobi early); None keeps the cap."""
    if step.device.type == "cpu":
        shampoo_refresh_roots_plain(step, mats, roots, identity_strength)
        return
    if step.device.type != "cuda":
        raise ValueError(f"shampoo_refresh_roots: unsupported device {step.device}")
    name = "shampoo_refresh_roots"
    mats, roots = list(mats), list(roots)
    if step.dtype != torch.int32 or step.dim() != 0:
        raise ValueError(f"{name}: the counter must be a 0-d int32 tensor, got {step.dtype} "
                         f"{tuple(step.shape)}")
    if len(mats) != len(roots):
        raise ValueError(f"{name}: {len(mats)} matrices and {len(roots)} roots")
    for a, root in zip(mats, roots):
        if (a.dtype != torch.float32 or a.dim() != 2 or a.shape[0] != a.shape[1]
                or not a.is_contiguous()):
            raise ValueError(f"{name}: each matrix must be square float32 contiguous, got "
                             f"{a.dtype} {tuple(a.shape)} strides {a.stride()}")
        if root.dtype != a.dtype or root.shape != a.shape or not root.is_contiguous():
            raise ValueError(f"{name}: a root must be the float32 contiguous shape of its "
                             f"matrix, got {root.dtype} {tuple(root.shape)}")
        if root.data_ptr() == a.data_ptr():
            raise ValueError(f"{name}: a root may not be its own matrix")
    if not mats:
        return
    if stats is None:
        stats = torch.empty((len(mats), 2), dtype=torch.int32, device=step.device)
    elif stats.dtype != torch.int32 or stats.shape != (len(mats), 2) or not stats.is_contiguous():
        raise ValueError(f"{name}: stats must be a contiguous ({len(mats)}, 2) int32 tensor")
    require_cuda_tensors(name, step, stats, *mats, *roots)
    ext = kernels()
    shampoo_refresh_roots.launches += ext.shampoo_root(
        step, mats, roots, float(identity_strength), stats,
        ext.shampoo_root_max_sweeps if max_sweeps is None else int(max_sweeps))


shampoo_refresh_roots.launches = 0

"""Collectives over ``torch.distributed`` process groups, for the parallel
layer and the row-sharded grid tables.

The JAX package's collectives are ``jax.lax.all_gather``,
``psum_scatter`` and ``pmean`` inside ``shard_map``
(``tcnn_tpu/ops/grid_ops.py:1197-1233``, ``tcnn_tpu/parallel/``); their
transposes come from JAX's autodiff.  Here ``all_gather`` and
``reduce_scatter`` are a pair of ``autograd.Function``s, each the other's
transpose: the backward of one calls the other through ``apply``, so a
backward taken with ``create_graph`` is itself differentiable (the eikonal
loss's second order through sharded tables).  ``torch.func`` transforms do
not pass through them (``grid_ops.grid_encode`` refuses a sharded table
under one).

Backends.  NCCL takes CUDA tensors.  Gloo serves the CPU tests and two
ranks that share one card (NCCL refuses two ranks on one device); on an
H100 with PyTorch 2.11 it took CUDA tensors, fp32 and bf16, in each
collective used here (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``broadcast``), and ``chip_smoke.py``'s parallel phase runs
them so; nothing is staged through host memory by this module.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist

# ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` are the names on
# every PyTorch this runs on; newer ones warn that they are deprecated.
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r"` is deprecated", category=FutureWarning)


def world(group=None) -> int:
    """The group's size; 1 in a process that joined no process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in the group; 0 in a process alone."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n = world(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ranks of ``x``, each rank keeping its block of ``dim``
    (rank r the r-th of world equal blocks), summed in fp32 and returned in
    ``x``'s dtype."""
    n = world(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    xt = x.movedim(dim, 0).float().contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.to(x.dtype).movedim(0, dim)


class AllGather(torch.autograd.Function):
    """All-gather along ``dim``; its transpose is ``ReduceScatter``."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return ReduceScatter.apply(g, ctx.group, ctx.dim), None, None


class ReduceScatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim``; its transpose is ``AllGather``."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return AllGather.apply(g, ctx.group, ctx.dim), None, None


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable all-gather of ``x`` along ``dim`` over ``group``."""
    return AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable sum-reduce-scatter of ``x`` along ``dim`` over ``group``."""
    return ReduceScatter.apply(x, group, dim)


def all_reduce_mean_(tensors, group=None, scale: Optional[float] = None) -> None:
    """In place: each tensor becomes the mean over the group's ranks (or
    the sum times ``scale``), in one flat fp32 all-reduce: the gradients of
    a step are packed into one buffer, one collective for all of them."""
    tensors = list(tensors)
    if not tensors:
        return
    n = world(group)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if n > 1:
        dist.all_reduce(flat, group=group)
    flat.mul_(1.0 / n if scale is None else scale)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


# The capture mode of a CUDA graph that holds NCCL collectives.  NCCL's
# watchdog thread queries the events of the warm-up step's collectives
# while the step is being captured; under "global" capture that query, an
# unsafe call from another thread, would invalidate the capture.
# "thread_local" holds only the capturing thread to the capture's rules.
CAPTURE_MODE = "thread_local"


def check_capturable(groups, device, entry: str = "make_training_loop",
                     eager: str = "step_shard_map takes eager steps") -> None:
    """Raises unless the collectives of ``groups`` can be captured in a
    CUDA graph on ``device``: on CUDA every group must be NCCL's (gloo's
    collectives run on the host and cannot be captured).  The message
    names the captured ``entry`` point that asks and ``eager``, what runs
    eagerly instead.  Nothing is captured on the CPU, and a process that
    joined no group calls no collective."""
    if torch.device(device).type != "cuda" or not dist.is_initialized():
        return
    for group in groups:
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise RuntimeError(
                f"{entry}: the {backend} backend's collectives cannot be captured in a CUDA "
                f"graph; on CUDA {entry} needs an NCCL process group ({eager} over "
                f"{backend})")


def broadcast_(tensors, src: int = 0, group=None) -> None:
    """In place: every tensor takes the value it has on global rank ``src``."""
    if world(group) == 1:
        return
    for t in tensors:
        dist.broadcast(t, src, group=group)

"""Data parallelism over ``torch.distributed`` ranks.

PyTorch counterpart of ``tcnn_tpu/parallel/mesh.py``.  JAX shards the
batch over a device mesh inside ``shard_map`` and ``pmean``s the
gradients; here each process is one rank on one device (``cuda`` unless
the caller asks for the CPU), the batch is sharded by rank, the parameters
and optimizer state are replicated, and the gradients and the loss are
averaged over the ranks' process group by one all-reduce per step.

    dist.init_process_group(...)               # launch.initialize_distributed
    dp = DataParallel()                        # all ranks
    dp.replicate(model.trainer)                # rank 0's parameters everywhere
    step = dp.make_training_step(model.trainer)
    loss = step(dp.shard_batch(x), dp.shard_batch(y))

The step runs eagerly.  Capturing it in a CUDA graph (NCCL collectives can
be captured, gloo's cannot) is for later (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import collectives


def make_mesh(ranks: Optional[Sequence[int]] = None):
    """The process group over the global ``ranks`` (None or every rank:
    the default group; None in a process that joined no group, which then
    runs alone).  Every rank must call it, with the same ranks
    (``torch.distributed.new_group``)."""
    if not dist.is_initialized():
        return None
    if ranks is None or list(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def shard_batch_over(x: torch.Tensor, n_devices: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``n_devices`` equal blocks of a (B, ...) batch;
    shared by DataParallel and HybridParallel so the divisibility contract
    lives in one place (``tcnn_tpu/parallel/mesh.py:37-45``)."""
    if x.shape[0] % n_devices:
        raise ValueError(
            f"batch size {x.shape[0]} not divisible by mesh size "
            f"{n_devices}")
    b = x.shape[0] // n_devices
    return x[index * b:(index + 1) * b]


def set_noise_stream(trainer, stream: int) -> None:
    """Gives the trainer's output perturbation its own noise stream
    (``Trainer.perturbation_noise``: the generator is seeded from the seed
    and the stream); a new stream starts a new generator."""
    if trainer.noise_stream != stream:
        trainer.noise_stream = stream
        trainer._noise_gen = None


class DataParallel:
    """Pure data parallelism: the batch sharded over the group's ranks,
    parameters replicated, gradients averaged by an all-reduce."""

    def __init__(self, mesh=None):
        self.group = mesh if mesh is not None else make_mesh()
        self.rank = collectives.rank(self.group)

    @property
    def n_devices(self) -> int:
        return collectives.world(self.group)

    # -- placement ----------------------------------------------------
    def shard_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a (B, ...) global batch."""
        return shard_batch_over(x, self.n_devices, self.rank)

    def replicate(self, trainer) -> None:
        """Broadcasts the trainer's parameters, optimizer state and step
        from the group's first rank, in place."""
        from ..optimizers.base import tree_leaves

        if self.n_devices == 1:
            return
        src = dist.get_global_rank(self.group, 0) if self.group is not dist.group.WORLD else 0
        with torch.no_grad():
            leaves = list(trainer.params().values()) + tree_leaves(trainer.opt_state)
            collectives.broadcast_(leaves, src, self.group)
            step = torch.tensor([trainer.step], dtype=torch.int64,
                                device=leaves[0].device if leaves else "cpu")
            dist.broadcast(step, src, group=self.group)
        trainer.step = int(step.item())

    # -- steps --------------------------------------------------------
    def make_training_step(self, trainer, with_pdf: bool = False):
        """``step(x, target[, pdf]) -> loss`` on this rank's batch block,
        following JAX's ``_per_shard`` (``tcnn_tpu/parallel/mesh.py:121-137``):
        ``trainer.loss_value_and_grads`` on the local batch, one all-reduce
        of the loss and every gradient divided by the world size (equal
        blocks make it the global mean), then the replicated optimizer
        step.  With output perturbation each rank draws its own noise: the
        trainer's noise stream is the rank's global rank
        (``Trainer.perturbation_noise``).  The loss returned is the mean
        over the ranks."""
        set_noise_stream(trainer, collectives.rank())

        def step(x, target, pdf=None):
            if with_pdf and pdf is None:
                raise ValueError("make_training_step(with_pdf=True): pass the pdf")
            loss, grads = trainer.loss_value_and_grads(x, target, pdf)
            names = list(grads)
            collectives.all_reduce_mean_([loss] + [grads[n] for n in names], self.group)
            trainer.optimizer.step(trainer.opt_state, grads, trainer.params())
            trainer.step += 1
            return loss

        return step

    def make_inference(self, trainer):
        """``infer(x) -> y``: this rank's batch block through the trainer's
        inference parameters; the blocks of all ranks are the global batch."""
        return trainer.inference

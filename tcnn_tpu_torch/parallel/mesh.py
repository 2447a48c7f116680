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
    loop = dp.make_training_loop(model.trainer, sample_fn, n_steps)
    losses = loop()           # sample_fn(i): this rank's block of step i

``make_training_step`` runs eagerly (over gloo or NCCL).
``make_training_loop`` is the counterpart of the JAX launcher's compiled
``lax.scan`` of ``step_shard_map``: on CUDA over NCCL its first call runs
one step eagerly (the warm-up, which also creates the communicators) and
captures the next, collectives included, in a CUDA graph that every later
step replays; on the CPU (gloo) it runs the same steps eagerly.  Gloo's
collectives cannot be captured, so a CUDA loop over gloo raises
(``collectives.check_capturable``).  One card holds one NCCL rank: there
the group has one rank and the step calls no collective, so the loop's
collectives in a graph show only across cards (``chip_smoke.py`` captures
each collective on its own at one rank).
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


def counted_step(trainer, body, with_pdf: bool):
    """``step(x, target[, pdf]) -> loss``: one eager step of ``body``,
    counted in ``trainer.step``."""
    def step(x, target, pdf=None):
        if with_pdf and pdf is None:
            raise ValueError("make_training_step(with_pdf=True): pass the pdf")
        loss = body(x, target, pdf)
        trainer.step += 1
        return loss

    return step


def parallel_training_loop(layer, trainer, body, groups, sample_fn, n_steps: int):
    """``Trainer.make_training_loop``'s loop over the step ``body`` of a
    parallel ``layer`` whose collectives run on ``groups``: the graphs are
    the trainer's (``Trainer._graphs``, which ``HybridParallel.shard_state``
    and ``update_hyperparams`` clear), keyed by the layer and the batch's
    shapes, and captured in ``collectives.CAPTURE_MODE``.  Each rank's
    output perturbation draws its own noise stream (its global rank), and
    its generator's state is registered with the graph."""
    device = next(iter(trainer.params().values())).device
    collectives.check_capturable(groups, device)
    set_noise_stream(trainer, collectives.rank())
    return lambda: trainer._run_loop(sample_fn, n_steps, body=body, key=(layer,),
                                     capture_error_mode=collectives.CAPTURE_MODE)


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
    def _step_body(self, trainer):
        """``body(x, target, pdf=None) -> loss``: one step on this rank's
        batch block, following JAX's ``_per_shard``
        (``tcnn_tpu/parallel/mesh.py:121-137``):
        ``trainer.loss_value_and_grads`` on the local batch, one all-reduce
        of the loss and every gradient divided by the world size (equal
        blocks make it the global mean), then the replicated optimizer
        step.  It does not count the step."""
        def body(x, target, pdf=None):
            loss, grads = trainer.loss_value_and_grads(x, target, pdf)
            names = list(grads)
            collectives.all_reduce_mean_([loss] + [grads[n] for n in names], self.group)
            trainer.optimizer.step(trainer.opt_state, grads, trainer.params())
            return loss

        return body

    def make_training_step(self, trainer, with_pdf: bool = False):
        """``step(x, target[, pdf]) -> loss`` on this rank's batch block,
        eagerly (``_step_body``).  With output perturbation each rank draws
        its own noise: the trainer's noise stream is the rank's global rank
        (``Trainer.perturbation_noise``).  The loss returned is the mean
        over the ranks."""
        set_noise_stream(trainer, collectives.rank())
        return counted_step(trainer, self._step_body(trainer), with_pdf)

    def make_training_loop(self, trainer, sample_fn, n_steps: int):
        """``loop() -> losses``: ``n_steps`` steps per call, an (n_steps,)
        tensor of the mean losses on the device; ``sample_fn(i)`` returns
        this rank's (x, target) block of step i.  The shape of
        ``Trainer.make_training_loop``: on CUDA over NCCL the first call's
        warm-up step runs eagerly and every later step replays a CUDA
        graph of the step; on the CPU the steps run eagerly.  Raises on a
        CUDA device unless the group is NCCL's.  Clear ``trainer._graphs``
        before ``destroy_process_group``: a graph that holds NCCL
        collectives must go before its communicators
        (``parallel/launch.py``)."""
        return parallel_training_loop(self, trainer, self._step_body(trainer), [self.group],
                                      sample_fn, n_steps)

    def make_inference(self, trainer):
        """``infer(x) -> y``: this rank's batch block through the trainer's
        inference parameters; the blocks of all ranks are the global batch."""
        return trainer.inference

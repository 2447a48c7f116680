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
    infer = dp.make_inference(model.trainer)
    y = infer(dp.shard_batch(x))              # this rank's block of the answer

``step_shard_map`` is the uncounted eager step, the counterpart of JAX's
unjitted ``step_shard_map``.  The compiled entry points are the
counterparts of JAX's jitted ones: ``make_training_step``,
``make_training_loop`` (the JAX launcher's compiled ``lax.scan`` of
``step_shard_map``) and ``make_inference``.  On CUDA over NCCL the first
call for a batch's shapes runs the step or request eagerly (the warm-up,
which also creates the communicators) and captures the next, collectives
included, in a CUDA graph that every later call replays; on the CPU
(gloo) the same steps and requests run eagerly.  Gloo's collectives
cannot be captured, so on CUDA over gloo each compiled entry point raises
before it runs anything (``collectives.check_capturable``); there
``step_shard_map`` takes eager steps.  The graphs are the trainer's
(``Trainer._graphs``), keyed by the layer and the entry point, so one
trainer stepped through the layer and through ``Trainer.make_training_step``
never replays the other's graph.  One card holds one NCCL rank: there the
group has one rank and the step calls no collective, so the collectives in
a graph show only across cards (``chip_smoke.py`` captures each collective
on its own at one rank).
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


def captured_entry(trainer, groups, entry: str,
                   eager: str = "step_shard_map takes eager steps") -> None:
    """Refuses, before it runs anything, a captured ``entry`` point whose
    ``groups``' collectives cannot be captured on the trainer's device
    (``collectives.check_capturable``)."""
    device = next(iter(trainer.params().values())).device
    collectives.check_capturable(groups, device, entry, eager)


def parallel_training_step(layer, trainer, groups, with_pdf: bool):
    """``make_training_step`` of a parallel ``layer`` whose collectives run
    on ``groups``: ``Trainer._compiled_step`` over ``layer.step_shard_map``,
    its graphs keyed by the layer and captured in
    ``collectives.CAPTURE_MODE``, the rank's noise generator registered."""
    captured_entry(trainer, groups, "make_training_step")
    return trainer._compiled_step(layer.step_shard_map(trainer, with_pdf=with_pdf), (layer,),
                                  with_pdf, collectives.CAPTURE_MODE)


def parallel_training_loop(layer, trainer, groups, sample_fn, n_steps: int):
    """``Trainer.make_training_loop``'s loop over ``layer.step_shard_map``:
    the graphs are the trainer's, keyed by the layer and the batch's
    shapes, and captured in ``collectives.CAPTURE_MODE``."""
    captured_entry(trainer, groups, "make_training_loop")
    body = layer.step_shard_map(trainer)
    return lambda: trainer._run_loop(sample_fn, n_steps, body=body, key=(layer,),
                                     capture_error_mode=collectives.CAPTURE_MODE)


def parallel_inference(layer, trainer, groups, body, eager: str):
    """``infer(x) -> y`` of a parallel ``layer``: ``body(x)`` as a request
    (``Trainer._request``), its graphs keyed by the layer and captured in
    ``collectives.CAPTURE_MODE``; an inference tensor."""
    captured_entry(trainer, groups, "make_inference", eager)

    def infer(x):
        with torch.inference_mode():
            return trainer._request(body, x, ("make_inference", layer),
                                    collectives.CAPTURE_MODE)

    return infer


def refuse_use_shard_map(use_shard_map: bool) -> None:
    """JAX's ``use_shard_map=False`` (a jit left to XLA's partitioner) has no
    counterpart: every step and request here is per rank."""
    if use_shard_map is not True:
        raise TypeError("use_shard_map=False: JAX's plain-jit lowering has no counterpart in "
                        "this package (every rank runs its own block)")


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
    def step_shard_map(self, trainer, with_pdf: bool = False):
        """The uncounted eager step ``body(x, target[, pdf]) -> loss`` on
        this rank's batch block, JAX's unjitted ``step_shard_map``
        (``tcnn_tpu/parallel/mesh.py:112-147``), for callers that take
        eager steps (and add one to ``trainer.step`` for each) or capture
        it themselves: ``trainer.loss_value_and_grads`` on the local batch,
        one all-reduce of the loss and every gradient divided by the world
        size (equal blocks make it the global mean), then the replicated
        optimizer step.  With output perturbation each rank draws its own
        noise: the trainer's noise stream becomes the rank's global rank
        (``Trainer.perturbation_noise``)."""
        set_noise_stream(trainer, collectives.rank())

        def body(x, target, pdf=None):
            loss, grads = trainer.loss_value_and_grads(x, target, pdf)
            names = list(grads)
            collectives.all_reduce_mean_([loss] + [grads[n] for n in names], self.group)
            trainer.optimizer.step(trainer.opt_state, grads, trainer.params())
            return loss

        if with_pdf:
            return body
        return lambda x, target: body(x, target)

    def make_training_step(self, trainer, with_pdf: bool = False, use_shard_map: bool = True):
        """The compiled step ``step(x, target[, pdf]) -> loss`` on this
        rank's batch block, counted in ``trainer.step``; the loss returned
        is the mean over the ranks (``tcnn_tpu/parallel/mesh.py:71-110``).
        The shape of ``Trainer.make_training_step``: on CUDA over NCCL the
        first call for a batch's shapes runs ``step_shard_map``'s step
        eagerly and captures the next, the all-reduce included, and later
        calls replay it; on the CPU the steps run eagerly.  On CUDA over
        gloo it raises before any step.  Shampoo is captured too (kernel
        SR: the ranks refresh the same all-reduced matrices, bit for bit).
        JAX's ``use_shard_map`` is accepted at its default only."""
        refuse_use_shard_map(use_shard_map)
        return parallel_training_step(self, trainer, [self.group], with_pdf)

    def make_training_loop(self, trainer, sample_fn, n_steps: int):
        """``loop() -> losses``: ``n_steps`` steps per call, an (n_steps,)
        tensor of the mean losses on the device; ``sample_fn(i)`` returns
        this rank's (x, target) block of step i.  The shape of
        ``Trainer.make_training_loop``: on CUDA over NCCL the first call's
        warm-up step runs eagerly and every later step replays a CUDA
        graph of the step; on the CPU the steps run eagerly.  On CUDA over
        gloo it raises.  Call
        ``trainer.invalidate_jit_cache()`` before ``destroy_process_group``:
        a graph that holds NCCL collectives must go before its
        communicators (``parallel/launch.py``)."""
        return parallel_training_loop(self, trainer, [self.group], sample_fn, n_steps)

    def make_inference(self, trainer, use_shard_map: bool = True):
        """``infer(x) -> y``: this rank's batch block through the trainer's
        inference parameters (``tcnn_tpu/parallel/mesh.py:149-164``); the
        blocks of all ranks are the global batch.  On CUDA over NCCL a
        request replays a CUDA graph per shape after its first call, as
        ``Trainer.inference`` does; on the CPU it runs eagerly; on CUDA
        over gloo it raises, as the layer's other compiled entry points do.
        JAX's ``use_shard_map`` is accepted at its default only."""
        refuse_use_shard_map(use_shard_map)
        return parallel_inference(self, trainer, [self.group],
                                  lambda x: trainer._inference_body(x),
                                  "Trainer.inference serves a rank's block")

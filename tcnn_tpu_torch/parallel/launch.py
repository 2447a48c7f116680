"""Multi-process launch and per-rank data feeding.

PyTorch counterpart of ``tcnn_tpu/parallel/launch.py``.  Every rank runs the
same program; ``initialize_distributed`` joins them into one
``torch.distributed`` process group, each rank on one device, and each rank
feeds only its own block of the global batch (``shard_host_local_batch``).

Run as a module for a self-contained training run:

    # one process per card (torchrun sets MASTER_ADDR, MASTER_PORT,
    # WORLD_SIZE, RANK and LOCAL_RANK):
    torchrun --nproc-per-node 4 -m tcnn_tpu_torch.parallel.launch --steps 100

    # two ranks on the CPU (gloo), with a checkpoint directory:
    torchrun --nproc-per-node 2 -m tcnn_tpu_torch.parallel.launch \\
        --device cpu --batch 4096 --n-model 2 --ckpt-dir run_ckpt

A single process (no torchrun) trains alone, in no process group.

Training runs one chunk of ``--chunk`` steps at a time through the parallel
layer's ``make_training_loop``, as the JAX launcher runs its compiled
``lax.scan`` of ``--chunk`` steps: each rank draws its step's global batch
on its device from a generator seeded with the step and keeps its block;
losses and checkpoints are read between chunks.  On cards (NCCL) the first
chunk's first step is the warm-up and every later step replays one CUDA
graph of the step, collectives included; on the CPU (gloo) the steps run
eagerly.  For comparison, ``--step`` trains through the compiled
``make_training_step`` (one call a step, each replaying the captured step
after the first), and ``--eager`` through ``step_shard_map`` (eager steps,
counted here).  One card holds one NCCL rank: a run across ranks needs a
card per rank.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device: Optional[str] = None) -> None:
    """Joins this process to the default process group.

    The arguments, else torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the ``env://`` init method), ``WORLD_SIZE``, ``RANK``
    and ``LOCAL_RANK`` (the card this rank uses, ``torch.cuda.set_device``).
    The backend is NCCL on CUDA and gloo where the caller asks for the CPU
    (``device="cpu"``).  A no-op for one process and when called twice.
    """
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size == 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timedelta(minutes=10))


def shard_host_local_batch(dp, *global_arrays) -> Tuple[torch.Tensor, ...]:
    """This rank's blocks of global batches (``dp`` a DataParallel or
    HybridParallel): the rank keeps only its own rows, as each JAX host
    feeds its local shard (``tcnn_tpu/parallel/launch.py:75-87``)."""
    return tuple(dp.shard_batch(torch.as_tensor(a)) for a in global_arrays)


# The inline model of the JAX launcher (tcnn_tpu/parallel/launch.py:123-131).
LAUNCH_CONFIG = {
    "loss": {"otype": "RelativeL2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 16,
                 "n_features_per_level": 2, "log2_hashmap_size": 15,
                 "base_resolution": 16, "per_level_scale": 1.5},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64,
                "n_hidden_layers": 2},
}


def _main(argv=None) -> None:
    import argparse
    import time

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=1 << 18, help="global batch size")
    parser.add_argument("--chunk", type=int, default=10,
                        help="training steps between loss reads (and checkpoints)")
    parser.add_argument("--n-model", type=int, default=1,
                        help="row-shard grid tables N ways over a model group "
                             "(hybrid data x model parallelism; 1 = pure data parallelism)")
    parser.add_argument("--ckpt-dir", type=str, default=None,
                        help="checkpoint directory: resumes from the newest step on "
                             "startup and saves every --ckpt-every steps (sharded "
                             "tables: one file per rank, written in place)")
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="save interval in steps (default: once per chunk)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu (gloo)")
    parser.add_argument("--init-method", type=str, default=None,
                        help="the process group's rendezvous (default env://, torchrun's; "
                             "file://PATH needs no port)")
    how = parser.add_mutually_exclusive_group()
    how.add_argument("--eager", action="store_true",
                     help="eager steps (step_shard_map) instead of the loop's captured ones")
    how.add_argument("--step", action="store_true",
                     help="one call of the compiled make_training_step a step instead of "
                          "the loop")
    args = parser.parse_args(argv)

    initialize_distributed(args.init_method, device=args.device)

    import tcnn_tpu_torch as tcnn
    from ..common import resolve_device
    from .mesh import DataParallel
    from .table_parallel import HybridParallel

    from ..ops import collectives

    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = collectives.rank(), collectives.world()
    barrier = dist.barrier if dist.is_initialized() else (lambda: None)
    hybrid = args.n_model > 1
    model = tcnn.create_from_config(2, 3, LAUNCH_CONFIG, policy=tcnn.BF16_POLICY,
                                    device=device)
    trainer = model.trainer
    if hybrid:
        dp = HybridParallel(n_model=args.n_model, model=model)
        dp.shard_state(trainer)
    else:
        dp = DataParallel()
        dp.replicate(trainer)
    if rank == 0:
        extra = f" (hybrid: tables sharded {args.n_model}-way)" if hybrid else ""
        how = ("eager steps (step_shard_map)" if args.eager
               else "make_training_step" if args.step else "make_training_loop")
        print(f"mesh: {world} ranks on {device.type}{extra}; {how}", flush=True)

    mgr = None
    resume_step = 0
    if args.ckpt_dir:
        from ..utils import checkpoint as ckpt

        # The tables' block-cyclic row order is baked into the saved
        # shards: refuse to resume under another layout.
        if rank == 0:
            ckpt.check_layout_tag(args.ckpt_dir, {"n_model": args.n_model})
        barrier()
        if rank:
            ckpt.check_layout_tag(args.ckpt_dir, {"n_model": args.n_model})
        every = args.ckpt_every or args.chunk
        mgr = ckpt.make_manager(args.ckpt_dir, max_to_keep=3, save_interval_steps=every)
        if ckpt.restore_latest(mgr, like=trainer) is not None:
            resume_step = trainer.step
            if rank == 0:
                print(f"resumed from step {resume_step}", flush=True)

    # Each rank draws the global batch of a step from an explicit
    # generator on its device, seeded from the step, and keeps its own
    # block.
    gen = torch.Generator(device)

    def batch(i):
        gen.manual_seed(i)
        x = torch.rand((args.batch, 2), generator=gen, device=device)
        t = torch.rand((args.batch, 3), generator=gen, device=device)
        return shard_host_local_batch(dp, x, t)

    if args.eager:
        body = dp.step_shard_map(trainer)

        def step(x, t):
            loss = body(x, t)
            trainer.step += 1
            return loss
    elif args.step:
        step = dp.make_training_step(trainer)

    def chunk(start, n):
        """Steps start .. start + n - 1; their losses on the device."""
        if args.eager or args.step:
            return torch.stack([step(*batch(start + i)) for i in range(n)])
        return dp.make_training_loop(trainer, lambda i: batch(start + i), n)()

    saving = mgr is not None and (hybrid or rank == 0)
    timed_from, t0 = resume_step, time.perf_counter()
    for start in range(resume_step, args.steps, args.chunk):
        n = min(args.chunk, args.steps - start)
        losses = chunk(start, n).tolist()   # waits for the chunk
        if rank == 0:
            print(f"steps {start + 1}-{start + n}: losses {losses}", flush=True)
        if saving:
            ckpt.save_step(mgr, trainer)
        if mgr is not None:
            barrier()
        if start == resume_step and start + n < args.steps:
            # the first chunk holds the warm-up and the capture: time the rest
            timed_from, t0 = start + n, time.perf_counter()
    dt = time.perf_counter() - t0
    n = args.steps - timed_from
    if rank == 0 and n:
        sps = n * args.batch / dt
        print(f"trained {args.steps - resume_step} steps of batch {args.batch}; the last {n} "
              f"in {dt:.2f}s: {sps:,.0f} samples/s ({sps / world:,.0f}/rank), final loss "
              f"{losses[-1]:.5f}", flush=True)
    # A CUDA graph that holds NCCL collectives must go before its
    # communicators: with the graphs alive, ranks hung at exit on 2 and 4
    # cards after their last step.
    trainer.invalidate_jit_cache()
    if dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.synchronize()
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()

"""The launcher across cards: DataParallel and HybridParallel, captured and eager.

    python3 -m tcnn_tpu_torch.tools.multicard [--nproc 2 4] [--steps 400]
        [--chunk 50] [--batch 262144] [--modes eager step loop]
        [--run-timeout 120] [--out DIR]

For each rank count N (at most the cards present): first each collective
of the parallel steps (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``) on an N-rank NCCL group, eagerly and replayed from a CUDA
graph (``parallel_check.collectives_job``); then ``torchrun
--nproc-per-node N -m tcnn_tpu_torch.parallel.launch`` (through ``python -m
torch.distributed.run --standalone``: a rendezvous on this host) trains the
launcher's model (``launch.LAUNCH_CONFIG``, BF16_POLICY) under
DataParallel (``--n-model 1``) and HybridParallel (``--n-model 2``) in
each of ``--modes``: ``eager`` (``--eager``, ``step_shard_map``'s eager
steps), ``step`` (``--step``, the compiled ``make_training_step``, one call
a step) and ``loop`` (``make_training_loop``); the last two replay a CUDA
graph of the step, NCCL collectives included.  All on the same seeded
global batches.  Builds the kernels once first.  Prints one JSON line per
check and run: the collectives' largest differences between replay and
eager call; the rank count, the mode, the samples/s after the first chunk
(which holds the warm-up and the capture), per card, and the losses of
steps 1, 2 and the last; then per (N, n_model) and captured mode the
largest relative difference of its losses from the eager steps' (and of
the step's from the loop's).  Fails
if a check or a run fails or outlives ``--run-timeout`` seconds (a
collective that never completes inside a replayed graph is not caught by
NCCL's watchdog), a loss is not finite, or the first loss of a captured
mode and its reference differ by more than ``FIRST_RTOL``.  Each run's
whole output goes to ``--out``.  The captured modes of N ranks are skipped
when the collectives of N ranks do not replay (within 1e-3 of the eager
calls, on inputs of unit scale).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np

# The same parameters and batch: the first step's mean loss differs only in
# the order of fp32 sums (chip_smoke.py's PARALLEL_FIRST_RTOL).
FIRST_RTOL = 1e-5
# The launcher's modes: its flag for each (the loop is its default).
MODES = {"eager": ["--eager"], "step": ["--step"], "loop": []}


def parse(out: str):
    """({step: loss}, samples/s) from the launcher's rank-0 output."""
    losses, sps = {}, None
    for line in out.splitlines():
        if line.startswith("steps "):
            span, values = line[len("steps "):].split(": losses ")
            first = int(span.split("-")[0])
            losses.update({first + i: v for i, v in enumerate(json.loads(values))})
        elif line.startswith("trained "):
            sps = float(line.split(": ", 1)[1].split(" samples/s")[0].replace(",", ""))
    return losses, sps


def run_logged(cmd, log: Path, timeout: float, **kw):
    """The exit code of ``cmd`` (None if it outlived ``timeout`` seconds and
    was killed with its process group), its output written to ``log``."""
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True, **kw)
        try:
            return proc.wait(timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            return None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--chunk", type=int, default=50)
    parser.add_argument("--batch", type=int, default=1 << 18)
    parser.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES),
                        help="the launcher's training modes to run (eager is the yardstick "
                             "of the others)")
    parser.add_argument("--run-timeout", type=float, default=120)
    parser.add_argument("--out", type=str, default="build/multicard")
    args = parser.parse_args(argv)

    import torch

    from ..ops.cuda import kernels
    from . import parallel_check

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"{torch.cuda.device_count()} card(s): {smi.splitlines()}", flush=True)
    kernels()   # built once here; the ranks load it
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    failed = []
    for n in args.nproc:
        if n > torch.cuda.device_count():
            print(f"skipping {n} ranks: {torch.cuda.device_count()} card(s)", flush=True)
            continue
        try:
            outs = parallel_check.run_ranks(n, parallel_check.collectives_job, {},
                                            timeout=args.run_timeout, backend="nccl")
            worst = {k: max(max(o[k]) for o in outs) for k in outs[0]}
            captured = all(v < 1e-3 for v in worst.values())   # NaN fails too
            print(json.dumps({"ranks": n, "collectives_replay_vs_eager_max_abs": worst}),
                  flush=True)
        except RuntimeError as e:
            captured, worst = False, str(e)[-2000:]
            print(f"{n} ranks: the collectives check failed: {worst}", flush=True)
        if not captured:
            failed.append(f"n{n} collectives")
        for n_model in (1, 2):
            runs = {}
            for mode in args.modes if captured else [m for m in args.modes if m == "eager"]:
                name = f"n{n}_model{n_model}_{mode}"
                cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", str(n), "-m", "tcnn_tpu_torch.parallel.launch",
                       "--steps", str(args.steps), "--chunk", str(args.chunk),
                       "--batch", str(args.batch), "--n-model", str(n_model)]
                cmd += MODES[mode]
                log = out_dir / f"{name}.log"
                rc = run_logged(cmd, log, args.run_timeout, cwd=root, env=env)
                out = log.read_text()
                losses, sps = parse(out)
                if rc != 0 or len(losses) != args.steps or sps is None or \
                        not np.isfinite(list(losses.values())).all():
                    failed.append(name)
                    print(f"{name}: FAILED ({'timed out' if rc is None else f'exit {rc}'}); "
                          f"the end of its output:\n{out[-3000:]}", flush=True)
                    continue
                runs[mode] = losses
                print(json.dumps({"ranks": n, "n_model": n_model, "mode": mode,
                                  "samples_per_s": sps, "samples_per_s_per_card": sps / n,
                                  "loss_1": losses[1], "loss_2": losses[2],
                                  f"loss_{args.steps}": losses[args.steps]}), flush=True)
            pairs = [(m, "eager") for m in runs if m != "eager" and "eager" in runs]
            pairs += [("step", "loop")] if {"step", "loop"} <= set(runs) else []
            for mode, ref in pairs:
                a = np.array([runs[mode][i] for i in sorted(runs[mode])])
                b = np.array([runs[ref][i] for i in sorted(runs[ref])])
                rel = np.abs(a - b) / np.abs(b)
                if rel[0] > FIRST_RTOL:
                    failed.append(f"n{n}_model{n_model} {mode} first loss")
                print(json.dumps({"ranks": n, "n_model": n_model,
                                  f"{mode}_vs_{ref}_first_rel": float(rel[0]),
                                  f"{mode}_vs_{ref}_max_rel": float(rel.max())}), flush=True)
            if "eager" in args.modes and "eager" not in runs and n_model == 1:
                break   # NCCL's eager steps fail: nothing more to learn at n ranks
    if failed:
        sys.exit(f"multicard: failed {failed}")


if __name__ == "__main__":
    main()

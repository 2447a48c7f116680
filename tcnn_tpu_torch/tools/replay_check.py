"""Replayed training steps against eager ones: the optimizer's counters.

``Trainer.make_training_loop`` replays a step captured in a CUDA graph;
``Trainer.training_step`` runs it eagerly.  From the same parameters on
the same batches the two differ only by the rounding of kernel GB, whose
fp32 atomics sum a table's gradient in an order that changes from run to
run; cast to a bf16 table's dtype, a gradient entry can come out one bf16
ulp apart in the two runs.  Integer state is held equal, with one
exception that the gradients themselves show: a lazy per-entry counter
(Adam's ``param_steps``) counts the optimizer steps whose gradient entry
is nonzero, and under Batched that entry is the mean of m steps'
gradients, a sum of bf16 values that can cancel to exactly 0 in one run
and not in the other.

``record_gradients`` keeps every step's gradients of a run;
``counter_mismatches`` holds every integer leaf of two runs' optimizer
states equal, except entries of a lazy counter whose recorded gradients
differ between the runs: there each run's counter must equal the count
that its own gradients give (``lazy_counts``).  ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` apply it to their replayed and eager runs.

Run on the card, it repeats Batched(Adam)'s replayed against eager steps
at config_hash (bf16, B = 2^18, the batches of ``chip_smoke.py``'s
slice-9 phase) and prints each repeat's differing counters with both
runs' gradients at them::

    python -m tcnn_tpu_torch.tools.replay_check --repeats 6
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch

from ..optimizers.base import named_leaves
from ..optimizers.wrappers import Batched

LAZY = "param_steps"


def record_gradients(trainer, n_steps: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Wraps ``trainer.optimizer.step`` so that every step (eager, the
    loop's warm-up, or a graph replay) copies its gradients into row
    ``i`` of an (n_steps, *shape) fp32 buffer per parameter, ``i`` a
    device counter.  Returns the buffers and the counter."""
    params = trainer.params()
    dev = next(iter(params.values())).device
    bufs = {n: torch.zeros((n_steps, *p.shape), dtype=torch.float32, device=dev)
            for n, p in params.items()}
    i = torch.zeros(1, dtype=torch.long, device=dev)
    step = trainer.optimizer.step

    def recording_step(state, grads, params, lr_scale=1.0):
        for n, g in grads.items():
            bufs[n].index_copy_(0, i, g.float().unsqueeze(0))
        i.add_(1)
        return step(state, grads, params, lr_scale)

    trainer.optimizer.step = recording_step
    return bufs, i


def nested_interval(optimizer) -> int:
    """Calls per step of the optimizer that keeps the lazy counters:
    Batched's multiplier, else 1."""
    return optimizer.multiplier if isinstance(optimizer, Batched) else 1


def step_means(grads: torch.Tensor, interval: int) -> torch.Tensor:
    """(n_steps // interval, ...): the gradient each optimizer step takes
    from recorded gradients (n_steps, ...), the mean of ``interval``
    calls' gradients summed in call order in fp32, as Batched sums them."""
    means = []
    for k in range(grads.shape[0] // interval):
        acc = torch.zeros_like(grads[0])
        for g in grads[k * interval:(k + 1) * interval]:
            acc.add_(g)
        means.append(acc / interval)
    return torch.stack(means)


def lazy_counts(grads: torch.Tensor, interval: int) -> torch.Tensor:
    """The lazy counter that recorded gradients give: the optimizer steps
    whose gradient entry (``step_means``) is nonzero."""
    return (step_means(grads, interval) != 0).sum(0, dtype=torch.int32)


def _param_of(leaf_name: str) -> str:
    parts = leaf_name.split(".")
    return ".".join(parts[parts.index(LAZY) + 1:])


def counter_mismatches(state_a, state_b, grads_a: Dict[str, torch.Tensor],
                       grads_b: Dict[str, torch.Tensor], interval: int
                       ) -> Tuple[List[str], List[dict]]:
    """Two runs' optimizer states: every integer leaf (and ExponentialDecay's
    factor) equal, but for the entries of a lazy counter whose recorded
    gradients differ between the runs, where each run's counter equals
    ``lazy_counts`` of its own gradients.  Returns (what failed, one
    witness per differing counter entry: both runs' counts, their
    gradients at the calls where they differ, and the mean each optimizer
    step took)."""
    failed, witnesses = [], []
    for (n, a), (_, b) in zip(named_leaves(state_a), named_leaves(state_b)):
        if b.is_floating_point() and not n.endswith("factor"):
            continue
        odd = (a != b).nonzero()
        if not len(odd):
            continue
        if LAZY not in n.split("."):
            failed.append(f"{n} differs at {len(odd)} entries")
            continue
        p = _param_of(n)
        idx = tuple(odd.t())
        ga, gb = grads_a[p][(slice(None), *idx)], grads_b[p][(slice(None), *idx)]
        want_a, want_b = lazy_counts(ga, interval), lazy_counts(gb, interval)
        same = (ga == gb).all(dim=0)
        bad = same | (want_a != a[idx]) | (want_b != b[idx])
        if bool(bad.any()):
            failed.append(f"{n}: {int(bad.sum())} of its {len(odd)} differing entries are not "
                          f"what the runs' own gradients give")
        mean_a, mean_b = step_means(ga, interval), step_means(gb, interval)
        for j in range(len(odd)):
            steps = (ga[:, j] != gb[:, j]).nonzero().view(-1).tolist()
            witnesses.append({
                "leaf": n, "entry": odd[j].tolist(), "counts": [int(a[idx][j]), int(b[idx][j])],
                "other gradients": {s: [float(ga[s, j]), float(gb[s, j])] for s in steps},
                "means": [[float(x) for x in mean_a[:, j]], [float(x) for x in mean_b[:, j]]]})
    return failed, witnesses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    from .. import BF16_POLICY, create_from_config, load_config
    from ..utils.image import ImageSampler, synthetic_image

    base = load_config("configs/config_hash.json")
    cfg = {**base, "optimizer": {"otype": "Batched", "batch_size_multiplier": 4,
                                 "nested": base["optimizer"]}}
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=0)
    batches = [sampler.sample_batch(1 << 18) for _ in range(10)]
    runs = []
    for r in range(args.repeats):
        pair = [create_from_config(2, 3, cfg, policy=BF16_POLICY) for _ in range(2)]
        rec = [record_gradients(m.trainer, args.steps) for m in pair]
        pair[0].trainer.make_training_loop(lambda i: batches[i % len(batches)], args.steps)()
        for i in range(args.steps):
            pair[1].trainer.training_step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        if [int(i) for _, i in rec] != [args.steps] * 2:
            raise RuntimeError(f"recorded {[int(i) for _, i in rec]} steps, not {args.steps}")
        failed, wit = counter_mismatches(pair[0].trainer.opt_state, pair[1].trainer.opt_state,
                                         rec[0][0], rec[1][0],
                                         nested_interval(pair[0].optimizer))
        grid = [g["encoding.grid"] for g, _ in rec]
        other = int((grid[0] != grid[1]).sum())
        print(f"repeat {r}: {len(wit)} counter entries differ (replayed, eager), "
              f"{'all' if not failed else 'NOT all'} as their own gradients give {failed}; "
              f"{other} of {grid[0].numel()} recorded table-gradient values differ")
        for w in wit:
            print("  " + json.dumps(w))
        runs.append({"differing": len(wit), "explained": not failed,
                     "gradient_values_differing": other})
    print(json.dumps({"replay_check": runs}))
    if not all(r["explained"] for r in runs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

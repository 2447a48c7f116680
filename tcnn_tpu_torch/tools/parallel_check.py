"""Training on two ranks of the parallel layer, against one process.

    python3 -m tcnn_tpu_torch.tools.parallel_check [--steps N] [--batch B]

``compare`` runs them, and the same training twice in one process, and
compares the losses, the tables and the trained models' predictions.
``run_ranks(world, train_job, args)`` spawns ``world`` ranks with
``torch.multiprocessing`` (gloo, or NCCL with ``backend="nccl"``; a
``file://`` rendezvous in a temporary directory), each on
``args["device"]``, and returns each rank's result.  On a card each rank
of ``train_job`` first asks for the layer's compiled entry points
(``make_training_loop``, ``make_training_step``, ``make_inference``),
which must refuse gloo, before it takes a step; its steps are the layer's
eager ``step_shard_map``.  ``nccl_loop_job`` runs on a one-rank NCCL
group (one card holds one NCCL rank): ``DataParallel.make_training_loop``
against ``Trainer.make_training_loop``, and each collective the steps use
replayed from a CUDA graph against an eager call (``chip_smoke.py``'s
slice-18 phase); ``nccl_sortseg_job`` runs the two loops under
``TCNN_TPU_SCATTER=sortseg`` (slice 19); ``nccl_compiled_job`` holds the
layers' compiled steps and requests against their eager ones (slice 22).
Three jobs of ``train_job``:

  * ``hybrid_btf``: configs/config_btf.json at BF16_POLICY (a Composite of
    a 4-D CoherentAdd hash grid of 15,474,688 parameters and OneBlob,
    FullyFusedMLP 64 x 3) under ``HybridParallel`` with n_model = world:
    the grid table and its Adam state row-sharded, kernels G, GB in shard
    mode, M and MB on each rank's block of the batch;
  * ``dp_hash``: configs/config_hash.json at BF16_POLICY under
    ``DataParallel``;
  * ``eikonal_sdf``: the SDF sample's model and loss
    (``samples/fit_sdf_eikonal.py``, fp32, its 3-D Smoothstep grid
    row-sharded) under ``HybridParallel``, each step through the grid's
    second order in shard mode (G, GB, GI and GG, which adds the shard's
    table gradient itself: no RS) and the collectives' transposes.

Each rank draws the same global batches (``fit_btf.batch_sampler``, an
``ImageSampler`` of ``synthetic_image(1024, 1024)``, the SDF sample's
``sample_points``, each from a seeded generator) and trains on its
block, eagerly; it reports the mean losses, the step's milliseconds (host
clock around a synchronised step) and the collectives' (host clock around
each, synchronised before and after), its kernel launches over the steps,
whether ``gather_state`` of the freshly sharded table gives the canonical
table back bit for bit, the first step's reduced gradients (the
optimizer's input, tables gathered to the canonical layout: a gradient
of the wrong scale shows there, where Adam's update would hide it), and
the trained table gathered back to the
canonical layout (``HybridParallel.gather_state``).  ``single_process`` trains the same
model, from the same seed, on the same global batches in one process.
Ranks that share one card show that the layer is right and what its
collectives cost, not how it scales.
"""

from __future__ import annotations

import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BTF_CONFIG = "configs/config_btf.json"
HASH_CONFIG = "configs/config_hash.json"
SEED = 7
TABLES = {"hybrid_btf": "encoding.0.grid", "dp_hash": "encoding.grid",
          "eikonal_sdf": "encoding.grid"}


def _model(job, device, optimizer=None):
    """The job's model from ``SEED``; ``optimizer`` (a config) in place of
    the config's own."""
    from .. import BF16_POLICY, Policy, create_from_config, load_config
    from ..samples import fit_sdf_eikonal

    root = Path(__file__).resolve().parents[2]
    if job == "eikonal_sdf":
        return create_from_config(3, 1, fit_sdf_eikonal.CONFIG, policy=Policy(), seed=SEED,
                                  device=device)
    n_in, cfg = (6, BTF_CONFIG) if job == "hybrid_btf" else (2, HASH_CONFIG)
    cfg = load_config(str(root / cfg))
    if optimizer is not None:
        cfg = {**cfg, "optimizer": optimizer}
    return create_from_config(n_in, 3, cfg, policy=BF16_POLICY, seed=SEED, device=device)


def _sampler(job, batch, device):
    """The global batches of step 0, 1, ... (each call the next)."""
    if job == "hybrid_btf":
        from ..samples.fit_btf import batch_sampler

        return batch_sampler(batch, device, seed=SEED)
    if job == "eikonal_sdf":
        from ..samples.fit_sdf_eikonal import sample_points

        gen = torch.Generator(device).manual_seed(SEED)
        return lambda i: sample_points(gen, batch, device)
    from ..utils.image import ImageSampler, synthetic_image

    sampler = ImageSampler(synthetic_image(1024, 1024), device=device, seed=SEED)
    return lambda i: sampler.sample_batch(batch)


def _eikonal_loss_and_grads(trainer):
    """The SDF sample's loss (surface term and 0.1 of the eikonal term) and
    its gradients, through the grid's second order (GI, GG)."""
    from ..samples.fit_sdf_eikonal import loss_and_grads

    return lambda xs, xv: loss_and_grads(trainer.model, xs, xv)


def _counters():
    from ..ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_fwd
    from ..ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_bwd,
                                        grid_encode_bwd_input, grid_encode_fwd)
    from ..ops.cuda.scatter import row_scatter_add
    from ..ops.cuda.shampoo_root import shampoo_refresh_roots
    from ..ops.cuda.sort_scatter import segment_sum, sort_keys

    return {"G": grid_encode_fwd, "GB": grid_encode_bwd, "GI": grid_encode_bwd_input,
            "GG": grid_encode_bwd_bwd, "RS": row_scatter_add, "M": fused_mlp_fwd,
            "MB": fused_mlp_bwd, "SK": sort_keys, "SS": segment_sum,
            "SR": shampoo_refresh_roots}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed_collectives(device, spent):
    """Wraps the collectives the layer calls so that each adds its host
    time, synchronised before and after, to ``spent[0]``."""
    def wrap(fn):
        def timed(*a, **k):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync(device)
            spent[0] += time.perf_counter() - t0
            return out
        return timed

    for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "broadcast"):
        setattr(dist, name, wrap(getattr(dist, name)))


def record_first_grads(trainer) -> dict:
    """{name: gradient} that the trainer's optimizer is given at its first
    step from now on (the step's reduced gradients on a rank), filled when
    that step runs."""
    seen = {}
    step = trainer.optimizer.step

    def recording(state, grads, params):
        if not seen:
            seen.update({n: g.detach().clone() for n, g in grads.items()})
        return step(state, grads, params)

    trainer.optimizer.step = recording
    return seen


def canonical_grads(dp, grads) -> dict:
    """``grads`` as fp32 CPU tensors, each sharded table's gradient
    gathered back to the canonical table (``HybridParallel.gather_table``;
    every rank of a model group must call it)."""
    sharded = getattr(dp, "sharded_names", ())
    return {n: (dp.gather_table(n, g) if n in sharded else g).detach().float().cpu()
            for n, g in grads.items()}


def grad_rel(got, want) -> dict:
    """{name: relative L2 distance of got[name] from want[name]} (the
    absolute distance where want[name] is zero)."""
    return {n: (_rel_l2(got[n], want[n]) if bool(want[n].any())
                else float(torch.linalg.norm(got[n].float()))) for n in want}


def eager_step(dp, trainer):
    """``step(x, target) -> loss``: one eager step of the layer's
    ``step_shard_map``, counted in ``trainer.step``."""
    body = dp.step_shard_map(trainer)

    def step(x, target):
        loss = body(x, target)
        trainer.step += 1
        return loss

    return step


def refusals(dp, trainer, n_steps):
    """{entry point: the message with which it refuses, or None}: the
    layer's compiled entry points, asked for before any step."""
    def refusal(make):
        try:
            make()
        except RuntimeError as e:
            return str(e)
        return None

    return {"loop": refusal(lambda: dp.make_training_loop(trainer, None, n_steps)),
            "step": refusal(lambda: dp.make_training_step(trainer)),
            "inference": refusal(lambda: dp.make_inference(trainer))}


def train_job(rank, world, args):
    """One job's steps on this rank (``hybrid_btf`` and ``eikonal_sdf``
    under HybridParallel with n_model = world, ``dp_hash`` under
    DataParallel), eagerly through ``step_shard_map``."""
    from ..parallel import DataParallel, HybridParallel

    job, device = args["job"], torch.device(args["device"])
    model = _model(job, device)
    trainer = model.trainer
    name = TABLES[job]
    if job == "dp_hash":
        dp = DataParallel()
        dp.replicate(trainer)
        round_trip = None
    else:
        canonical = trainer.params()[name].detach().clone()
        dp = HybridParallel(n_model=world, model=model)
        dp.shard_state(trainer)
        round_trip = bool(torch.equal(dp.gather_state(trainer)["params"][name],
                                      canonical.cpu()))
    # on a card the compiled entry points must refuse gloo before a step or a batch
    refused = refusals(dp, trainer, args["steps"]) if device.type == "cuda" else {}
    step = eager_step(dp, trainer)
    if job == "eikonal_sdf":
        loss_and_grads = _eikonal_loss_and_grads(trainer)

        def step(xs, xv):   # the sample's step under the sharded tables
            with dp.sharded():
                loss, grads = loss_and_grads(xs, xv)
            dp.reduce_gradients(loss, grads)
            trainer.optimizer.step(trainer.opt_state, grads, trainer.params())
            return loss
    first_grads = record_first_grads(trainer)
    sample = _sampler(job, args["batch"], device)
    spent = [0.0]
    _timed_collectives(device, spent)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, coll_ms = [], [], []
    for i in range(args["steps"]):
        a, b = sample(i)
        a, b = dp.shard_batch(a), dp.shard_batch(b)
        _sync(device)
        spent[0] = 0.0
        t0 = time.perf_counter()
        losses.append(step(a, b))
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(spent[0] * 1e3)
    launches = {k: fn.launches for k, fn in counters.items()}
    if job == "dp_hash":
        params = {n: p.detach().cpu() for n, p in trainer.params().items()}
    else:
        params = dp.gather_state(trainer)["params"]
    grads = canonical_grads(dp, first_grads)
    if rank == 0:
        torch.save(params, args["params_out"])
        torch.save(grads, args["params_out"] + ".grads")
    return {"losses": [float(v) for v in losses], "step_ms": step_ms,
            "collective_ms": coll_ms, "launches": launches, "n_devices": dp.n_devices,
            "shard_numel": trainer.params()[name].numel(), "round_trip": round_trip,
            "refusals": refused}


def _graph_of(trainer):
    """The one CUDA graph of a trainer's loop."""
    (cap,) = trainer._graphs.values()
    return cap.graph


def _loop_times(loop, n_steps, graph, rounds):
    """(ms per step of ``loop()`` on the host clock, the device's ms per
    step replaying ``graph`` back to back between CUDA events), each the
    median of ``rounds``."""
    host, device = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / n_steps)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_steps):
            graph.replay()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / n_steps)
    return float(np.median(host)), float(np.median(device))


def _captured_collectives(device):
    """Each collective of the parallel steps (``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_reduce``) on this group, eagerly and
    replayed from a CUDA graph captured in ``collectives.CAPTURE_MODE``, on
    two fills of the input: {name: [max abs difference per fill]}.  The
    port's wrappers skip a one-rank group, so these call
    ``torch.distributed`` itself, at the shapes of config_hash's step: its
    gradients, the (2^18, 2) batch and a (32, 2^18) block of features."""
    from ..ops.collectives import CAPTURE_MODE

    n = dist.get_world_size()
    gen = torch.Generator(device).manual_seed(SEED)
    cases = {
        "all_reduce": (torch.empty(1 << 20, device=device), lambda i: i.clone(),
                       lambda i, o: (o.copy_(i), dist.all_reduce(o))),
        "all_gather_into_tensor": (torch.empty((1 << 18, 2), device=device),
                                   lambda i: i.new_empty((n * i.shape[0], 2)),
                                   lambda i, o: dist.all_gather_into_tensor(o, i)),
        "reduce_scatter_tensor": (torch.empty((n * 32, 1 << 18), device=device),
                                  lambda i: i.new_empty((32, 1 << 18)),
                                  lambda i, o: dist.reduce_scatter_tensor(o, i)),
    }
    out = {}
    for name, (inp, make_out, call) in cases.items():
        inp.normal_(generator=gen)
        static = make_out(inp)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm-up: creates the communicator
            call(inp, static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE):
            call(inp, static)
        diffs = []
        for _ in range(2):
            inp.normal_(generator=gen)
            eager = make_out(inp)
            call(inp, eager)
            graph.replay()
            torch.cuda.synchronize()
            diffs.append(float((static - eager).abs().max()))
        out[name] = diffs
    return out


def collectives_job(rank, world, args):
    """``_captured_collectives`` on this rank's card."""
    return _captured_collectives(torch.device("cuda", torch.cuda.current_device()))


def _two_loops(batch, steps, device):
    """``DataParallel.make_training_loop`` and ``Trainer.make_training_loop``
    of config_hash (BF16_POLICY), each on a fresh model from one seed,
    ``steps`` steps of the same ``batch``-sample batches, run once: the
    losses, each kernel's launches before the capture (the warm-up step)
    and in the captured step (each replay launches these), and the trained
    weights; with the loops, the DataParallel layer and its trainer."""
    from ..parallel import DataParallel

    counters = _counters()
    sample = _sampler("dp_hash", batch, device)
    batches = [sample(i) for i in range(steps)]
    at_capture = {}
    capture_begin = torch.cuda.CUDAGraph.capture_begin

    def counting_capture_begin(graph, *a, **k):
        at_capture.update({k_: fn.launches for k_, fn in counters.items()})
        return capture_begin(graph, *a, **k)

    loops, res = {}, {"losses": {}, "warm_up": {}, "per_replay": {}, "ms": {},
                      "device_ms": {}, "weights": {}}
    torch.cuda.CUDAGraph.capture_begin = counting_capture_begin
    try:
        for what in ("parallel", "trainer"):
            trainer = _model("dp_hash", device).trainer
            if what == "parallel":
                dp, dp_trainer = DataParallel(), trainer
                dp.replicate(trainer)
                loop = dp.make_training_loop(trainer, lambda i: batches[i], steps)
            else:
                loop = trainer.make_training_loop(lambda i: batches[i], steps)
            for fn in counters.values():
                fn.launches = 0
            res["losses"][what] = loop().tolist()
            after = {k: fn.launches for k, fn in counters.items()}
            res["warm_up"][what] = dict(at_capture)
            res["per_replay"][what] = {k: after[k] - at_capture[k] for k in after}
            res["weights"][what] = [p.detach().clone() for p in trainer.params().values()]
            loops[what] = (loop, _graph_of(trainer))
    finally:
        torch.cuda.CUDAGraph.capture_begin = capture_begin
    return res, loops, (dp, dp_trainer), batches


def nccl_sortseg_job(rank, world, args):
    """``_two_loops`` under ``TCNN_TPU_SCATTER=sortseg`` on a one-rank NCCL
    group: the DataParallel loop's capture takes the route's sort (kernels
    SK and SS in the warm-up and in each replay, no GB); the losses of both
    loops, their launches, and whether their trained weights are equal bit
    for bit."""
    import os

    os.environ["TCNN_TPU_SCATTER"] = "sortseg"
    device = torch.device("cuda", torch.cuda.current_device())
    res, _, _, _ = _two_loops(args["batch"], args["steps"], device)
    weights = res.pop("weights")
    res["same_weights"] = all(torch.equal(a, b)
                              for a, b in zip(weights["parallel"], weights["trainer"]))
    res["backend"] = dist.get_backend()
    return res


def nccl_loop_job(rank, world, args):
    """On a one-rank NCCL group: ``DataParallel.make_training_loop``
    training config_hash (BF16_POLICY) for ``args["steps"]`` steps of
    ``args["batch"]`` from the seeded image sampler, and
    ``Trainer.make_training_loop`` of the same model on the same batches
    in this process: both loops' losses, each kernel's launches before the
    capture (the warm-up step) and in the captured step (each replay
    launches these), both loops' ms per step (host clock) and device ms
    per replayed step over ``args["rounds"]`` more calls, in turns, and
    the ms per step of ``DataParallel.step_shard_map``'s eager steps on
    the same batches (host clock, ``args["rounds"]`` passes); then
    ``_captured_collectives``."""
    device = torch.device("cuda", torch.cuda.current_device())
    steps = args["steps"]
    res, loops, (dp, dp_trainer), batches = _two_loops(args["batch"], steps, device)
    del res["weights"]
    for what in ("parallel", "trainer", "trainer", "parallel"):
        loop, graph = loops[what]
        ms, device_ms = _loop_times(loop, steps, graph, args["rounds"])
        res["ms"].setdefault(what, []).append(ms)
        res["device_ms"].setdefault(what, []).append(device_ms)
    step = eager_step(dp, dp_trainer)   # the same steps, eagerly
    res["eager_ms"] = []
    for _ in range(args["rounds"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, t in batches:
            step(x, t)
        torch.cuda.synchronize()
        res["eager_ms"].append((time.perf_counter() - t0) * 1e3 / steps)
    res["backend"] = dist.get_backend()
    res["collectives"] = _captured_collectives(device)
    return res


def _least_ms(fn, rounds):
    """The least host-clock ms of ``fn()`` over ``rounds`` calls, each from
    an idle card to the end of its device work."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _replay_ms(graph, n):
    """The device's ms per replay of ``graph``, n replays back to back
    between CUDA events."""
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def nccl_compiled_job(rank, world, args):
    """The layers' compiled entry points on a one-rank NCCL group (slice
    22): config_hash (BF16_POLICY), fresh models from one seed,
    ``args["steps"]`` steps of ``args["batch"]`` samples from the seeded
    image sampler.
      * Under ``TCNN_TPU_SCATTER=sortseg`` (a deterministic table gradient),
        for DataParallel and HybridParallel (n_model 1):
        ``make_training_step`` against as many eager ``step_shard_map``
        steps and against ``Trainer.make_training_step``: whether the
        losses and the trained weights are equal bit for bit, the launches
        of each run, the step count, whether the step's graph key names
        the layer; then ``make_inference`` on ``held_out`` inputs, its
        first call (warm-up and capture) and a replay against the model's
        eager inference, bit for bit, with the launches of each.
      * Without it (GB's atomics), the main path: DataParallel's
        ``make_training_step``, its losses and launches beside
        ``Trainer.make_training_step``'s losses; then the host-clock ms
        per step of the compiled step, the eager ``step_shard_map`` steps
        and ``Trainer.make_training_step`` (passes over the batches, the
        least of ``args["rounds"]``, in turns), and the device ms per
        replay of both captured steps.
    ``args["optimizer"]`` (a config) replaces config_hash's optimizer in
    every model (slice 23 takes Shampoo), and ``args["main"] = False``
    leaves out the part without sortseg; ``args["device"]`` (default: the
    rank's card) lets it run on the CPU too."""
    import contextlib
    import os

    from ..parallel import DataParallel, HybridParallel

    device = torch.device(args.get("device", "cuda"))
    optimizer = args.get("optimizer")
    counters = _counters()
    sample = _sampler("dp_hash", args["batch"], device)
    batches = [sample(i) for i in range(args["steps"])]
    x = held_out("dp_hash", device)

    def layer_of(kind, model):
        if kind == "data":
            layer = DataParallel()
            layer.replicate(model.trainer)
        else:
            layer = HybridParallel(n_model=1, model=model)
            layer.shard_state(model.trainer)
        return layer

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def run(step, model):
        for fn in counters.values():
            fn.launches = 0
        losses = torch.stack([step(*b) for b in batches])
        torch.cuda.synchronize()
        return {"losses": losses, "launches": counts(),
                "weights": [p.detach().clone() for p in model.trainer.params().values()]}

    def same(a, b):
        return bool(torch.equal(a["losses"], b["losses"])) and all(
            torch.equal(u, v) for u, v in zip(a["weights"], b["weights"]))

    res = {"backend": dist.get_backend(), "sortseg": {}}
    os.environ["TCNN_TPU_SCATTER"] = "sortseg"
    try:
        m = _model("dp_hash", device, optimizer)
        ref = run(m.trainer.make_training_step(), m)
        for kind in ("data", "hybrid"):
            m = _model("dp_hash", device, optimizer)
            layer = layer_of(kind, m)
            compiled = run(layer.make_training_step(m.trainer), m)
            keys = [k for k in m.trainer._graphs if k[0] == "make_training_step"]
            e = _model("dp_hash", device, optimizer)
            eager = run(eager_step(layer_of(kind, e), e.trainer), e)
            infer = layer.make_inference(m.trainer)
            for fn in counters.values():
                fn.launches = 0
            first = infer(x)
            torch.cuda.synchronize()
            at_capture = counts()
            again = infer(x)
            torch.cuda.synchronize()
            replay = {k: v - at_capture[k] for k, v in counts().items()}
            with torch.inference_mode(), (layer.sharded() if kind == "hybrid"
                                          else contextlib.nullcontext()):
                want = m.trainer.model.inference(x)
            res["sortseg"][kind] = {
                "same_as_eager": same(compiled, eager), "same_as_trainer": same(compiled, ref),
                "launches": compiled["launches"], "eager_launches": eager["launches"],
                "trainer_launches": ref["launches"], "step": m.trainer.step,
                "key_names_layer": len(keys) == 1 and keys[0][1] is layer,
                "losses": compiled["losses"].tolist(),
                "inference_equal": bool(torch.equal(first, want) and torch.equal(again, want)),
                "inference_is_inference": bool(again.is_inference()),
                "inference_launches": {"capture": at_capture, "replay": replay}}
    finally:
        del os.environ["TCNN_TPU_SCATTER"]
    if not args.get("main", True):
        return res

    m = _model("dp_hash", device, optimizer)
    dp = layer_of("data", m)
    step = dp.make_training_step(m.trainer)
    main = run(step, m)
    t = _model("dp_hash", device, optimizer)
    trainer_step = t.trainer.make_training_step()
    res["main"] = {"losses": main["losses"].tolist(), "launches": main["launches"],
                   "trainer_losses": run(trainer_step, t)["losses"].tolist()}
    e = _model("dp_hash", device, optimizer)
    steps = {"parallel": step, "trainer": trainer_step,
             "eager": eager_step(layer_of("data", e), e.trainer)}
    res["ms"] = {}
    for what in ("parallel", "trainer", "eager", "eager", "trainer", "parallel"):
        ms = _least_ms(lambda: [steps[what](*b) for b in batches], args["rounds"])
        res["ms"].setdefault(what, []).append(ms / len(batches))
    res["device_ms"] = {what: _replay_ms(next(c.graph for k, c in model.trainer._graphs.items()
                                              if k[0] == "make_training_step"), len(batches))
                        for what, model in (("parallel", m), ("trainer", t))}
    return res


def held_out(job, device):
    """Inputs of no training batch, where the trained models are compared."""
    gen = torch.Generator(device).manual_seed(99)
    n_in = {"hybrid_btf": 6, "dp_hash": 2, "eikonal_sdf": 3}[job]
    return torch.rand((1 << 16, n_in), generator=gen, device=device) * 0.9 + 0.05


def single_process(job, steps, batch, device):
    """The same training in this process: (losses, the trained model, the
    first step's gradients as fp32 CPU tensors)."""
    model = _model(job, device)
    trainer = model.trainer
    first_grads = record_first_grads(trainer)
    sample = _sampler(job, batch, device)
    if job == "eikonal_sdf":
        loss_and_grads = _eikonal_loss_and_grads(trainer)

        def step(xs, xv):
            loss, grads = loss_and_grads(xs, xv)
            trainer.optimizer.step(trainer.opt_state, grads, trainer.params())
            return loss
    else:
        step = trainer.training_step
    losses = [float(step(*sample(i))) for i in range(steps)]
    return losses, model, canonical_grads(None, first_grads)


def _worker(rank, world, init, fn, args, out, timeout, backend):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout))
    try:
        res = fn(rank, world, args)
    except BaseException:
        res = {"__error__": traceback.format_exc()}
    Path(out).write_bytes(pickle.dumps(res))
    dist.destroy_process_group()


def run_ranks(world, fn, args, timeout=600, tmp=None, backend="gloo"):
    """``fn(rank, world, args)`` (a module-level function: the ranks import
    it) in ``world`` spawned ranks of a ``backend`` group (gloo, or NCCL
    with rank r on card r) joined through a ``file://`` rendezvous in
    ``tmp`` (default a temporary directory); the ranks' results.  A rank
    that raises, or outlives ``timeout`` seconds, fails the run with its
    traceback."""
    with tempfile.TemporaryDirectory(dir=tmp) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_worker, args=(r, world, f"{tmp}/init", fn, args,
                                                   f"{tmp}/out{r}.pkl", timeout, backend))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        outs = []
        for r in range(world):
            out = Path(f"{tmp}/out{r}.pkl")
            if not out.exists():
                raise RuntimeError(f"rank {r} ended with code {procs[r].exitcode}, no result")
            res = pickle.loads(out.read_bytes())
            if "__error__" in res:
                raise RuntimeError(f"rank {r} failed:\n{res['__error__']}")
            outs.append(res)
    return outs


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def compare(job, world, steps, batch, device, params_out):
    """Both trainings, and one more in this process: the ranks' results and
    {"losses": the single process's, "grad_rel": {name: the relative L2
    distance of the ranks' first reduced gradient from the single
    process's first gradient}, "table_rel": the relative L2 distance
    of the ranks' gathered table from the single process's table,
    "pred_rel": of the predictions on ``held_out`` of a model holding the
    ranks' gathered parameters from the single process's, and the same two
    between two single-process runs ("repeat_table_rel",
    "repeat_pred_rel")}."""
    outs = run_ranks(world, train_job, {"job": job, "device": str(device), "steps": steps,
                                        "batch": batch, "params_out": params_out})
    ref_losses, ref, ref_grads = single_process(job, steps, batch, device)
    _, again, _ = single_process(job, steps, batch, device)
    gathered = _model(job, device)
    with torch.no_grad():
        for n, p in gathered.trainer.params().items():
            p.copy_(torch.load(params_out)[n])
    name, x = TABLES[job], held_out(job, device)
    table = {m: mod.trainer.params()[name].detach() for m, mod in
             (("ref", ref), ("again", again), ("gathered", gathered))}
    pred = {m: mod.trainer.inference(x) for m, mod in
            (("ref", ref), ("again", again), ("gathered", gathered))}
    return outs, {"losses": ref_losses,
                  "grad_rel": grad_rel(torch.load(params_out + ".grads"), ref_grads),
                  "table_rel": _rel_l2(table["gathered"], table["ref"]),
                  "pred_rel": _rel_l2(pred["gathered"], pred["ref"]),
                  "repeat_table_rel": _rel_l2(table["again"], table["ref"]),
                  "repeat_pred_rel": _rel_l2(pred["again"], pred["ref"])}


def main(argv=None):
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=1 << 18)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from ..ops.cuda import kernels

        kernels()   # built here, once, and loaded by the ranks
    for job in ("hybrid_btf", "dp_hash", "eikonal_sdf"):
        batch = args.batch if job != "eikonal_sdf" else min(args.batch, 1 << 14)
        with tempfile.TemporaryDirectory() as tmp:
            outs, ref = compare(job, 2, args.steps, batch, args.device, f"{tmp}/params.pt")
        print(json.dumps({"job": job, "rank_losses": outs[0]["losses"], **ref,
                          "step_ms": float(np.median(outs[0]["step_ms"])),
                          "collective_ms": float(np.median(outs[0]["collective_ms"])),
                          "launches": outs[0]["launches"]}))


if __name__ == "__main__":
    main()

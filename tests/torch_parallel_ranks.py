"""The ranks of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_grid.py).

This module imports torch and ``tcnn_tpu_torch`` only, never jax: each
rank is a process of its own, spawned with ``torch.multiprocessing`` and
joined to a gloo process group through a ``file://`` init method in the
test's temporary directory (no TCP port, so test workers cannot collide).
``run(world, tmp, job, payload)`` runs ``JOBS[job](rank, world, payload)``
in every rank (``tools.parallel_check.run_ranks``) and returns each rank's
result dict (numpy arrays and plain values), which the tests compare with
the JAX package in their own process.
"""

from __future__ import annotations

import math
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tcnn_tpu_torch.tools.parallel_check import run_ranks

RANK_TIMEOUT_S = 240


def run(world: int, tmp, job: str, payload) -> list:
    """``JOBS[job]`` in ``world`` spawned gloo ranks; the ranks' results."""
    return run_ranks(world, JOBS[job], payload, RANK_TIMEOUT_S, tmp)


def _np(t):
    return t.detach().cpu().float().numpy() if t.is_floating_point() else \
        t.detach().cpu().numpy()


def _raises(fn, exc):
    """The message of the ``exc`` that fn() raises (None if it raises none)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


# -- the sharded encode (tests/test_torch_sharded_grid.py) -------------------

def make_spec(kw):
    """A grid spec of the port from plain keyword values (enums by name)."""
    from tcnn_tpu_torch.common import GridType, HashType
    from tcnn_tpu_torch.ops import grid_ops

    kw = dict(kw)
    if "hash_type" in kw:
        kw["hash_type"] = HashType.from_string(kw["hash_type"])
    if "grid_type" in kw:
        kw["grid_type"] = GridType.from_string(kw["grid_type"])
    if "interpolation" in kw:
        from tcnn_tpu_torch.common import InterpolationType
        kw["interpolation"] = InterpolationType.from_string(kw["interpolation"])
    return grid_ops.make_grid_spec(**kw)


def _encode_case(rank, n, case):
    """One grid case on this rank's shard: the forward, the table and input
    gradients of ⟨y, dy⟩, the eikonal loss's table gradient (÷ n: the
    group-mean convention) and the masked forward."""
    from tcnn_tpu_torch.ops import grid_ops

    spec = make_spec(case["spec"])
    group = dist.group.WORLD
    perm = grid_ops.block_cyclic_perm(spec, n)
    k = spec.n_params // n
    shard = torch.from_numpy(case["table"][perm[rank * k:(rank + 1) * k]])
    b = case["x"].shape[0] // n
    x = torch.from_numpy(case["x"][rank * b:(rank + 1) * b])
    dy = torch.from_numpy(case["dy"][rank * b:(rank + 1) * b])
    out = {}
    with grid_ops.sharded_tables(group, n):
        t = shard.clone().requires_grad_()
        xv = x.clone().requires_grad_()
        y = grid_ops.grid_encode(spec, t, xv)
        gt, gx = torch.autograd.grad((y * dy).sum(), [t, xv])
        out.update(y=_np(y), g=_np(gt), dx=_np(gx))

        t = shard.clone().requires_grad_()
        xv = x.clone().requires_grad_()
        (gxv,) = torch.autograd.grad(grid_ops.grid_encode(spec, t, xv).sum(), xv,
                                     create_graph=True)
        (ge,) = torch.autograd.grad((gxv * gxv).mean(), t)
        out["eik"] = _np(ge / n)

        if case.get("frac") is not None:
            frac = torch.from_numpy(case["frac"][rank * b:(rank + 1) * b])
            out["y_frac"] = _np(grid_ops.grid_encode(spec, shard, x, max_level_per_element=frac))
        # a full-size (replicated) table takes the ordinary path
        out["y_full"] = _np(grid_ops.grid_encode(spec, torch.from_numpy(case["table"]), x))
    return out


def encode_job(rank, world, payload):
    """The sharded encode's cases on ``world`` shards, and its refusals."""
    from tcnn_tpu_torch.ops import grid_ops

    res = {name: _encode_case(rank, world, case) for name, case in payload["cases"].items()}
    spec = make_spec(dict(payload["cases"]["hash2d"]["spec"], stochastic_interpolation=True))
    shard = torch.zeros(spec.n_params // world)
    x = torch.rand(8, spec.n_dims)
    with grid_ops.sharded_tables(dist.group.WORLD, world):
        res["stochastic"] = _raises(lambda: grid_ops.grid_encode(spec, shard, x),
                                    NotImplementedError)
        spec = make_spec(payload["cases"]["hash2d"]["spec"])
        shard = torch.zeros(spec.n_params // world)
        res["func"] = _raises(lambda: torch.func.grad(
            lambda t: grid_ops.grid_encode(spec, t, x).sum())(shard), NotImplementedError)
    return res


# -- HybridParallel, DataParallel, checkpoints (tests/test_torch_parallel.py) --

def _model(run):
    """The run's model on the CPU with the JAX package's initial parameters
    and optimizer state."""
    import tcnn_tpu_torch as tcnn
    from tcnn_tpu_torch.utils.jax_params import load_jax_opt_state, load_jax_params

    model = tcnn.create_from_config(run["n_in"], 3, run["config"], device="cpu")
    load_jax_params(model, run["params"])
    if run.get("opt_state") is not None:
        load_jax_opt_state(model.trainer, run["opt_state"])
    return model


def _hybrid_run(run):
    from tcnn_tpu_torch.parallel import HybridParallel, make_hybrid_mesh
    from tcnn_tpu_torch.tools.parallel_check import canonical_grads, record_first_grads

    model = _model(run)
    trainer = model.trainer
    hp = HybridParallel(make_hybrid_mesh(run["n_model"]), model=model)
    hp.shard_state(trainer)
    shapes = {n: tuple(p.shape) for n, p in trainer.params().items()}
    from tcnn_tpu_torch.optimizers.base import named_leaves
    state_shapes = {p: tuple(t.shape) for p, t in named_leaves(trainer.opt_state)}
    step = hp.make_training_step(trainer)
    first = record_first_grads(trainer)
    losses = [float(step(hp.shard_batch(torch.from_numpy(x)), hp.shard_batch(torch.from_numpy(t))))
              for x, t in run["batches"]]
    grads = {n: g.numpy() for n, g in canonical_grads(hp, first).items()}
    gathered = hp.gather_state(trainer)
    out = {"losses": losses, "shapes": shapes, "state_shapes": state_shapes,
           "sharded": hp.sharded_names, "grads": grads,
           "params": {n: _np(p) for n, p in gathered["params"].items()},
           "opt": {p: _np(t) for p, t in named_leaves(gathered["opt_state"])}}
    if run.get("infer") is not None:
        out["y"] = _np(hp.make_inference(trainer)(hp.shard_batch(torch.from_numpy(run["infer"]))))
    if run.get("loop"):
        for what, fn in (("loop", _loop_run), ("shard_map", _shard_map_run)):
            other = _model(run)
            other_hp = HybridParallel(hp.mesh, model=other)
            other_hp.shard_state(other.trainer)
            out[what] = fn(other_hp, other.trainer, run["batches"], trainer)
    return out


def _loop_run(dp, trainer, batches, eager):
    """``dp.make_training_loop`` over the batches on ``trainer``: its
    losses, its parameters (tables gathered) and whether its parameters,
    optimizer state and step equal those of ``eager``, the trainer that
    took the same steps through ``make_training_step``."""
    def sample(i):
        x, t = batches[i]
        return dp.shard_batch(torch.from_numpy(x)), dp.shard_batch(torch.from_numpy(t))

    losses = dp.make_training_loop(trainer, sample, len(batches))()
    return _against(dp, trainer, losses, eager)


def _shard_map_run(dp, trainer, batches, eager):
    """``_loop_run`` for eager steps of ``dp.step_shard_map``, each counted
    here; "uncounted": whether the step left ``trainer.step`` alone."""
    body = dp.step_shard_map(trainer)
    losses, uncounted = [], True
    for x, t in batches:
        before = trainer.step
        losses.append(body(dp.shard_batch(torch.from_numpy(x)), dp.shard_batch(torch.from_numpy(t))))
        uncounted &= trainer.step == before
        trainer.step += 1
    return dict(_against(dp, trainer, losses, eager), uncounted=uncounted)


def _against(dp, trainer, losses, eager):
    """The losses, the parameters (tables gathered) and whether the
    parameters, optimizer state and step equal those of ``eager``."""
    from tcnn_tpu_torch.optimizers.base import named_leaves

    mine = list(trainer.params().values()) + [t for _, t in named_leaves(trainer.opt_state)]
    theirs = list(eager.params().values()) + [t for _, t in named_leaves(eager.opt_state)]
    state_equal = trainer.step == eager.step and all(
        torch.equal(a, b) for a, b in zip(mine, theirs))
    params = (dp.gather_state(trainer)["params"] if hasattr(dp, "gather_state")
              else trainer.params())
    return {"losses": [float(v) for v in losses], "state equal": state_equal,
            "params": {n: _np(p) for n, p in params.items()}}


def _data_parallel_run(run):
    from tcnn_tpu_torch.parallel import DataParallel
    from tcnn_tpu_torch.tools.parallel_check import canonical_grads, record_first_grads

    model = _model(run)
    trainer = model.trainer
    dp = DataParallel()
    dp.replicate(trainer)
    step = dp.make_training_step(trainer)
    first = record_first_grads(trainer)
    losses = [float(step(dp.shard_batch(torch.from_numpy(x)), dp.shard_batch(torch.from_numpy(t))))
              for x, t in run["batches"]]
    out = {"losses": losses, "n_devices": dp.n_devices,
           "grads": {n: g.numpy() for n, g in canonical_grads(dp, first).items()},
           "params": {n: _np(p) for n, p in trainer.params().items()}}
    if run.get("loop"):
        for what, fn in (("loop", _loop_run), ("shard_map", _shard_map_run)):
            other = _model(run)
            other_dp = DataParallel()
            other_dp.replicate(other.trainer)
            out[what] = fn(other_dp, other.trainer, run["batches"], trainer)
    return out


def _replicate(rank, run):
    """Each rank's parameters, optimizer state and step made its own
    (rank r adds r/100 to every floating leaf and r + 3 to the step), then
    ``DataParallel.replicate``: what every rank holds after it."""
    from tcnn_tpu_torch.optimizers.base import named_leaves
    from tcnn_tpu_torch.parallel import DataParallel

    model = _model(run)
    trainer = model.trainer
    leaves = [(f"param {n}", t) for n, t in trainer.params().items()] + \
        [(f"state {p}", t) for p, t in named_leaves(trainer.opt_state)]
    with torch.no_grad():
        for _, t in leaves:
            if t.is_floating_point():
                t.add_(rank / 100)
    trainer.step = rank + 3 if rank else 0
    DataParallel().replicate(trainer)
    return {"leaves": {n: _np(t) for n, t in leaves}, "step": trainer.step}


def _noise(run):
    """Each rank's output-perturbation noise after DataParallel sets its
    stream, and the perturbed step's loss against the unperturbed one."""
    from tcnn_tpu_torch.parallel import DataParallel

    out = {}
    for sigma in (0.5, None):
        model = _model(run)
        model.trainer.perturbation_sigma = sigma
        dp = DataParallel()
        step = dp.make_training_step(model.trainer)
        x, t = run["batches"][0]
        out[f"loss {sigma}"] = float(step(dp.shard_batch(torch.from_numpy(x)),
                                          dp.shard_batch(torch.from_numpy(t))))
        if sigma:
            model.trainer._noise_gen = None   # the stream from its start
            out["noise"] = _np(model.trainer.perturbation_noise((1 << 14,), "cpu"))
    return out


def _checkpoint_and_guard(rank, run, tmp):
    """A sharded round trip through per-rank checkpoint files, the layout
    tag, and the serialization guard then ``gather_state``."""
    from tcnn_tpu_torch import serving
    from tcnn_tpu_torch.optimizers.base import named_leaves
    from tcnn_tpu_torch.parallel import HybridParallel, make_hybrid_mesh
    from tcnn_tpu_torch.utils import checkpoint as ckpt
    from tcnn_tpu_torch.utils import cuda_export

    out = {}
    model = _model(run)
    trainer = model.trainer
    blob0 = trainer.serialize()
    mesh = make_hybrid_mesh(run["n_model"])
    hp = HybridParallel(mesh, model=model)
    hp.shard_state(trainer)
    for what, fn in (("serialize", trainer.serialize),
                     ("export_snapshot", lambda: cuda_export.export_snapshot(trainer)),
                     ("export_inference", lambda: serving.export_inference(
                         trainer, batch_sizes=(256,)))):
        out[f"guard {what}"] = _raises(fn, ValueError)
    blob1 = trainer.serialize(state=hp.gather_state(trainer))
    out["blob params equal"] = blob0["params"] == blob1["params"]
    out["blob optimizer equal"] = blob0["optimizer"] == blob1["optimizer"]
    out["blob n_params equal"] = blob0["n_params"] == blob1["n_params"]

    step = hp.make_training_step(trainer)
    x, t = run["batches"][0]
    xs, ts = hp.shard_batch(torch.from_numpy(x)), hp.shard_batch(torch.from_numpy(t))
    step(xs, ts)
    ckpt.save_checkpoint(Path(tmp) / "ck", trainer)
    dist.barrier()
    out["files"] = sorted(p.name for p in (Path(tmp) / "ck").iterdir())
    like = _model(run)
    HybridParallel(mesh, model=like).shard_state(like.trainer)
    ckpt.restore_checkpoint(Path(tmp) / "ck", like=like.trainer)
    a = list(named_leaves(trainer.opt_state)) + list(trainer.params().items())
    b = list(named_leaves(like.trainer.opt_state)) + list(like.trainer.params().items())
    out["restored equal"] = all(torch.equal(u, v) for (_, u), (_, v) in zip(a, b)) and \
        like.trainer.step == trainer.step
    loss_a = float(step(xs, ts))
    loss_b = float(hp.make_training_step(like.trainer)(xs, ts))
    out["next step"] = (loss_a, loss_b)

    tag = Path(tmp) / "tagged"
    if rank == 0:
        ckpt.check_layout_tag(tag, {"n_model": run["n_model"]})
    dist.barrier()
    ckpt.check_layout_tag(tag, {"n_model": run["n_model"]})
    out["tag refuses"] = _raises(lambda: ckpt.check_layout_tag(tag, {"n_model": 4}), ValueError)

    mgr = ckpt.make_manager(Path(tmp) / "run", max_to_keep=2, save_interval_steps=1)
    for _ in range(3):
        step(xs, ts)
        ckpt.save_step(mgr, trainer)
        dist.barrier()
    out["manager steps"] = mgr.all_steps(ckpt.state_name(trainer))
    return out


def parallel_job(rank, world, payload):
    """HybridParallel runs, DataParallel runs, the noise streams and (with
    ``payload["guard"]``) checkpoints and the serialization guard, in the
    order given (every rank makes the same groups in the same order)."""
    from tcnn_tpu_torch.ops import collectives
    from tcnn_tpu_torch.parallel import HybridParallel, make_hybrid_mesh

    res = {}
    for name, run in payload["hybrid"].items():
        res[name] = _hybrid_run(run)
    for name, run in payload["data"].items():
        res[name] = _data_parallel_run(run)
    if payload.get("noise") is not None:
        res["noise"] = _noise(payload["noise"])
    if payload.get("replicate") is not None:
        res["replicate"] = _replicate(rank, payload["replicate"])
    if payload.get("guard") is not None:
        res["guard"] = _checkpoint_and_guard(rank, payload["guard"], payload["tmp"])
    res["bad mesh"] = _raises(lambda: make_hybrid_mesh(3), ValueError) if world % 3 else None
    res["capture check"] = {
        dev: _raises(lambda: collectives.check_capturable([dist.group.WORLD], torch.device(dev)),
                     RuntimeError) for dev in ("cuda", "cpu")}
    res["compiled on cuda"] = _compiled_on_cuda(world)
    res["no n_model"] = _raises(lambda: HybridParallel(), ValueError)
    return res


class _CardTrainer:
    """A trainer whose parameters say that they lie on a card: all that
    the layers' compiled entry points read before they refuse gloo there.
    Anything more they touch fails the test."""

    def params(self):
        return {"w": types.SimpleNamespace(device=torch.device("cuda", 0))}


def _compiled_on_cuda(world):
    """{layer: {entry point: the refusal}} of each layer's compiled entry
    points for a trainer on a card over this gloo group, asked for before
    any step or batch."""
    from tcnn_tpu_torch.parallel import DataParallel, HybridParallel
    from tcnn_tpu_torch.tools.parallel_check import refusals

    return {name: refusals(layer, _CardTrainer(), 4)
            for name, layer in (("data", DataParallel()),
                                ("hybrid", HybridParallel(n_model=world)))}


JOBS = {"encode": encode_job, "parallel": parallel_job}


def logistic_ok(noise: np.ndarray) -> bool:
    """Standard logistic: mean 0 and variance π²/3, within sampling error
    of 2^14 draws (5 standard errors)."""
    n = noise.size
    var = math.pi ** 2 / 3
    return abs(noise.mean()) < 5 * math.sqrt(var / n) and abs(noise.var() / var - 1) < 0.1

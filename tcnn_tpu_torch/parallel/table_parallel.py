"""Hybrid data × model parallelism: row-sharded grid tables.

PyTorch counterpart of ``tcnn_tpu/parallel/table_parallel.py``.  The ranks
form an (n_data, n_model) mesh, model axis innermost: rank = d·n_model + m.

* The sample batch is sharded flat over all ranks (every rank holds
  distinct samples, so the MLP and the loss scale with every rank).
* Every grid table whose levels split n_model ways, and every optimizer
  leaf that mirrors it, is row-sharded over the model group in the
  block-cyclic layout (``grid_ops.block_cyclic_perm``): rank m holds rows
  [m·S_l/n, (m+1)·S_l/n) of every level l.  Under
  ``grid_ops.sharded_tables`` each grid all-gathers its model group's
  batch, runs kernels G and GB (and GI, GG) in shard mode on its shard,
  and reduce-scatters the partial features back to their ranks.
* Everything else (the MLP, OneBlob, tables that do not divide) stays
  replicated, with its gradient averaged over every rank.

    mesh = make_hybrid_mesh(n_model=2)          # every rank, same order
    hp = HybridParallel(mesh, model=model)
    hp.shard_state(model.trainer)               # in place
    step = hp.make_training_step(model.trainer)
    loss = step(hp.shard_batch(x), hp.shard_batch(y))
    loop = hp.make_training_loop(model.trainer, sample_fn, n_steps)
    losses = loop()           # sample_fn(i): this rank's block of step i
    y = hp.make_inference(model.trainer)(hp.shard_batch(x))
    canonical = hp.gather_state(model.trainer)  # CPU tensors, canonical rows

Each rank runs on one device; one card can hold several ranks (gloo), which
shows correctness, not scaling.  ``step_shard_map`` is the uncounted eager
step.  ``make_training_step``, ``make_training_loop`` and
``make_inference`` capture the step or the request in a CUDA graph on
NCCL, as ``DataParallel``'s do (``parallel/mesh.py``), inside
``sharded()``, so that the graph holds the grids' all-gather and
reduce-scatter (``ops/collectives.py``); their graphs are keyed by the
layer, so a graph captured unsharded is never replayed sharded.  The
warm-up runs every collective that the capture then records (the
all-gather and reduce-scatter of the grids in shard mode on the model
group, the gradient all-reduces on the data group and the whole mesh; a
one-rank group calls none), so each communicator exists before the
capture, and fills the grid kernels' per-shard caches of level constants
and plans, which are host copies.  On CUDA over gloo they raise before
they run anything.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import collectives, grid_ops
from .mesh import (parallel_inference, parallel_training_loop, parallel_training_step,
                   set_noise_stream, shard_batch_over)


class HybridMesh(NamedTuple):
    """A rank's place in the (n_data, n_model) mesh and its groups."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    model_group: Any   # the ranks d·n_model + 0 .. n_model-1 of this rank's d
    data_group: Any    # the ranks 0 .. n_data-1 ·n_model + m of this rank's m
    group: Any         # every rank of the mesh


def make_hybrid_mesh(n_model: int, group=None) -> HybridMesh:
    """The (world/n_model, n_model) mesh over the ranks of ``group`` (None:
    all); the model axis innermost, as JAX's (``tcnn_tpu/parallel/
    table_parallel.py:62-73``).  Every rank creates every model group and
    every data group, in the same order (``torch.distributed.new_group``)."""
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} devices not divisible by n_model={n_model}")
    n_data = world // n_model
    ranks = (list(range(world)) if group is dist.group.WORLD
             else [dist.get_global_rank(group, r) for r in range(world)])
    me = dist.get_rank(group)
    d, m = divmod(me, n_model)

    def new_group(members):
        if len(members) == len(ranks):
            return group
        return dist.new_group([ranks[i] for i in members])

    model_groups = [new_group([dd * n_model + mm for mm in range(n_model)])
                    for dd in range(n_data)]
    data_groups = [new_group([dd * n_model + mm for dd in range(n_data)])
                   for mm in range(n_model)]
    return HybridMesh(n_data, n_model, d, m, model_groups[d], data_groups[m], group)


def _resolve_module(model):
    """The module itself, a Trainer or a TrainableModel."""
    if hasattr(model, "grid_specs"):
        return model
    for attr in ("model", "network"):
        sub = getattr(model, attr, None)
        if sub is not None and hasattr(sub, "grid_specs"):
            return sub
    trainer = getattr(model, "trainer", None)
    if trainer is not None and hasattr(trainer.model, "grid_specs"):
        return trainer.model
    raise TypeError(f"cannot resolve a module with grid_specs() from {type(model)}")


def _map_tree(tree, fn, prefix: str = ""):
    """A copy of an optimizer-state tree with fn(path, tensor) at each
    tensor leaf, containers rebuilt with their types (paths as
    ``optimizers.base.named_leaves`` gives them)."""
    if isinstance(tree, dict):
        out = type(tree)()
        for k, v in tree.items():
            out[k] = _map_tree(v, fn, f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, f"{prefix}{i}.") for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(prefix[:-1], tree)
    return tree


class HybridParallel:
    """Data-parallel batch + model-parallel (row-sharded) grid tables.

    ``model`` (the module, its Trainer or TrainableModel) supplies each grid
    table's spec by parameter name (``Module.grid_specs``); without it every
    table stays replicated.
    """

    def __init__(self, mesh: Optional[HybridMesh] = None, *, n_model: Optional[int] = None,
                 model: Any = None):
        if mesh is None:
            if n_model is None:
                raise ValueError("pass a hybrid mesh or n_model")
            mesh = make_hybrid_mesh(n_model)
        self.mesh = mesh
        self.n_data, self.n_model = mesh.n_data, mesh.n_model
        self.rank = collectives.rank(mesh.group)
        # {table parameter name: (spec, this rank's element indices into
        # the canonical table, the inverse permutation)}
        self._tables: Dict[str, Tuple[Any, np.ndarray, np.ndarray]] = {}
        if model is not None and self.n_model > 1:
            for name, spec in _resolve_module(model).grid_specs().items():
                if grid_ops.shardable_levels(spec, self.n_model):
                    perm = grid_ops.block_cyclic_perm(spec, self.n_model)
                    k = perm.size // self.n_model
                    mine = perm[mesh.model_index * k:(mesh.model_index + 1) * k]
                    self._tables[name] = (spec, mine, np.argsort(perm))

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    @property
    def sharded_names(self):
        return tuple(self._tables)

    def _table_of(self, path: str, n: int) -> Optional[str]:
        """The table whose leaf (or per-parameter mirror: an optimizer
        moment, a wrapper's copy or ring buffer, its path ending with the
        parameter's name) this is, with the table's n elements on its last
        axis (``tcnn_tpu/parallel/table_parallel.py:164-178``)."""
        for name, (spec, _, _) in self._tables.items():
            if (path == name or path.endswith("." + name)) and n == spec.n_params:
                return name
        return None

    # -- placement ------------------------------------------------------
    def shard_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global batch, sharded flat over all ranks."""
        return shard_batch_over(x, self.n_devices, self.rank)

    def shard_state(self, trainer) -> None:
        """In place: each shardable table, and every optimizer leaf that
        mirrors it, becomes this rank's block-cyclic shard; the rest stays
        as it is (replicated).  The optimizer's scratch is rebuilt at the
        new shapes and captured training graphs are dropped."""
        if trainer.shard_info is not None:
            raise ValueError("shard_state: the trainer's tables are sharded already")
        params = trainer.params()
        old_state = trainer.opt_state
        with torch.no_grad():
            for name, (_, mine, _) in self._tables.items():
                p = params[name]
                p.data = p.data[torch.from_numpy(mine).to(p.device)].contiguous()

            def shard(path, t):
                name = self._table_of(path, t.shape[-1] if t.ndim else -1)
                if name is None:
                    return t
                return t[..., torch.from_numpy(self._tables[name][1]).to(t.device)].contiguous()

            sharded = _map_tree(old_state, shard)
            # init rebuilds the optimizer's scratch at the new shapes; the
            # fresh state is then overwritten with the sharded old one.
            fresh = trainer.optimizer.init(trainer.params(), trainer.model.param_layout())
            _copy_tree(fresh, sharded)
        trainer.opt_state = fresh
        trainer.invalidate_jit_cache()
        trainer.shard_info = {"n_model": self.n_model, "rank": collectives.rank(),
                              "model_rank": self.mesh.model_index}

    def gather_state(self, trainer) -> Dict[str, Any]:
        """Inverse of ``shard_state``, not in place: {"params": {name:
        tensor}, "opt_state": tree, "step": int} as CPU tensors with every
        table leaf all-gathered over the model group and put back in the
        canonical row order, what checkpoints in the canonical layout and
        exports must see (``Trainer.serialize(state=...)``).  Every rank of
        a model group must call it."""
        def unshard(path, t):
            name = self._table_of(path, t.shape[-1] * self.n_model if t.ndim else -1) \
                if trainer.shard_info is not None else None
            if name is None:
                return t.detach().cpu().clone()
            return self.gather_table(name, t).cpu()

        params = {n: unshard(n, p) for n, p in trainer.params().items()}
        return {"params": params, "opt_state": _map_tree(trainer.opt_state, unshard),
                "step": int(trainer.step)}

    def gather_table(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The canonical table-sized tensor of table ``name`` from this
        rank's shard ``t`` of it (the shard on the last axis: the table, a
        mirror of it, or its gradient): all-gathered over the model group
        and put back in the canonical row order.  Every rank of a model
        group must call it."""
        full = collectives._all_gather(t.detach().contiguous(), self.mesh.model_group, -1)
        return full[..., torch.from_numpy(self._tables[name][2]).to(full.device)]

    # -- steps ----------------------------------------------------------
    def step_shard_map(self, trainer, with_pdf: bool = False):
        """The uncounted eager step ``body(x, target[, pdf]) -> loss`` on
        this rank's block of the flat-sharded batch, JAX's unjitted
        ``step_shard_map`` (``tcnn_tpu/parallel/table_parallel.py:
        229-289``, which returns a factory of it per state structure; here
        the step reads the trainer's state itself), for callers that take
        eager steps (adding one to ``trainer.step`` for each) or capture it
        themselves.  Gradients combine as JAX's (:253-273):
          * replicated leaves: the mean over every rank;
          * sharded tables: the sum over the model group's local losses
            arrives through the all-gather's transpose, so the mean over
            the data group divided by n_model;
          * the loss: the mean over every rank.
        Each rank's output perturbation draws its own noise stream, its
        global rank."""
        set_noise_stream(trainer, collectives.rank())

        def body(x, target, pdf=None):
            with self.sharded():
                loss, grads = trainer.loss_value_and_grads(x, target, pdf)
            self.reduce_gradients(loss, grads)
            trainer.optimizer.step(trainer.opt_state, grads, trainer.params())
            return loss

        if with_pdf:
            return body
        return lambda x, target: body(x, target)

    def _groups(self):
        mesh = self.mesh
        return [mesh.group, mesh.model_group, mesh.data_group]

    def make_training_step(self, trainer, with_pdf: bool = False):
        """The compiled step ``step(x, target[, pdf]) -> loss``, counted in
        ``trainer.step`` (``tcnn_tpu/parallel/table_parallel.py:291-307``),
        as ``DataParallel.make_training_step``: on CUDA over NCCL the first
        call for a batch's shapes runs ``step_shard_map``'s step eagerly
        and captures the next, and later calls replay it; on the CPU the
        steps run eagerly.  On CUDA over gloo it raises before any step.
        Shampoo is captured too (kernel SR)."""
        return parallel_training_step(self, trainer, self._groups(), with_pdf)

    def make_training_loop(self, trainer, sample_fn, n_steps: int):
        """``loop() -> losses`` of ``n_steps`` steps per call, as
        ``DataParallel.make_training_loop``: ``sample_fn(i)`` returns this
        rank's (x, target) block of step i; on CUDA over NCCL every step
        after the first call's warm-up replays a CUDA graph of the step;
        on the CPU the steps run eagerly.  On CUDA over gloo it raises."""
        return parallel_training_loop(self, trainer, self._groups(), sample_fn, n_steps)

    def sharded(self):
        """The ``grid_ops.sharded_tables`` context of this mesh's model
        group, for a loss of one's own (the step enters it itself)."""
        return grid_ops.sharded_tables(self.mesh.model_group, self.n_model)

    def reduce_gradients(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor]) -> None:
        """In place: a rank's local loss and gradients (taken under
        ``sharded()``) become the step's, combined as in
        ``step_shard_map``; a custom loss's step (the eikonal loss, for
        one) calls it between its gradients and the optimizer."""
        shard = [g for n, g in grads.items() if n in self._tables]
        rep = [g for n, g in grads.items() if n not in self._tables]
        collectives.all_reduce_mean_(shard, self.mesh.data_group,
                                     scale=1.0 / (self.n_data * self.n_model))
        collectives.all_reduce_mean_([loss] + rep, self.mesh.group)

    def make_inference(self, trainer):
        """``infer(x) -> y``: this rank's block of a flat-sharded batch
        through the table-sharded model with the trainer's inference
        parameters (``tcnn_tpu/parallel/table_parallel.py:309-331``; every
        rank of a model group calls it together).  On CUDA over NCCL a
        request replays a CUDA graph per shape after its first call, the
        model group's all-gather and reduce-scatter included; on the CPU it
        runs eagerly; on CUDA over gloo it raises."""
        def body(x):
            with self.sharded():
                return trainer._inference_body(x)

        return parallel_inference(self, trainer, [self.mesh.model_group], body,
                                  "the model's inference under sharded() runs eagerly")


def _copy_tree(dst, src) -> None:
    """Copies the tensor leaves of ``src`` into the same-shaped tree ``dst``."""
    from ..optimizers.base import named_leaves

    d, s = list(named_leaves(dst)), list(named_leaves(src))
    if [p for p, _ in d] != [p for p, _ in s]:
        raise ValueError("shard_state: the optimizer's state changed structure")
    for (path, a), (_, b) in zip(d, s):
        if a.shape != b.shape:
            raise ValueError(f"shard_state: {path} {tuple(a.shape)} vs {tuple(b.shape)}")
        a.copy_(b)


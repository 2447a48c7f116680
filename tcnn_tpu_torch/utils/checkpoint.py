"""Checkpoint and resume.

PyTorch counterpart of ``tcnn_tpu/utils/checkpoint.py:37-142``.  The JAX
package writes its whole TrainerState with orbax; the port writes a
trainer's parameters, optimizer state and step with ``torch.save`` and
reads them with ``torch.load(weights_only=True)``, which unpickles
tensors and plain containers only.  The leaves are kept as lists in the
JAX flatten order (``optimizers.base.named_leaves``), with their paths,
and restored into a trainer of the same configuration in place.

    from tcnn_tpu_torch.utils import checkpoint as ckpt
    ckpt.save_checkpoint(path, trainer)                 # one-shot
    ckpt.restore_checkpoint(path, like=fresh_trainer)   # in place

    mgr = ckpt.make_manager(dir, max_to_keep=3, save_interval_steps=100)
    for ...:
        trainer.training_step(x, t)
        ckpt.save_step(mgr, trainer)      # no-op between intervals
    ckpt.restore_latest(mgr, like=fresh_trainer)

A trainer whose grid tables ``parallel.HybridParallel.shard_state`` has
sharded saves and restores its own shard in place, with no gather: each
rank writes ``state.rank<r>.pt`` (r its global rank) into the same
directory, and restores its own file into a trainer sharded the same way.
The block-cyclic row order is then baked into the files, so
``check_layout_tag`` records the layout ({"n_model": n}) beside the
checkpoints and refuses to resume under another.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from ..optimizers.base import named_leaves
from .serialization import param_leaves

_STATE_NAME = "state.pt"
_LAYOUT_NAME = "table_layout.json"


def _abs(path) -> str:
    return os.path.abspath(os.fspath(path))


def check_layout_tag(directory, layout: Dict[str, Any]) -> None:
    """Records the table layout beside the checkpoints on the first call
    (``table_layout.json``: {"n_model": n}, the model group's size the
    tables were sharded over, 1 the canonical layout) and refuses a
    different one later (``tcnn_tpu/utils/checkpoint.py:58``): resuming
    under another n_model would restore permuted tables.  The file is
    written whole (aside, then renamed), so ranks may call this together."""
    path = os.path.join(_abs(directory), _LAYOUT_NAME)
    if os.path.exists(path):
        with open(path) as fh:
            recorded = json.load(fh)
        if recorded != layout:
            raise ValueError(
                f"checkpoint dir {directory} was written with table "
                f"layout {recorded}, but this run uses {layout}; "
                "resuming would silently restore permuted grid tables. "
                "Use a fresh checkpoint directory or match the recorded layout.")
    else:
        os.makedirs(_abs(directory), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(layout, fh)
        os.replace(tmp, path)


def state_name(trainer) -> str:
    """The file a trainer's checkpoint is in: ``state.pt``, or under
    sharded tables the rank's own ``state.rank<r>.pt``."""
    info = getattr(trainer, "shard_info", None)
    return _STATE_NAME if info is None else f"state.rank{info['rank']}.pt"


def _contents(trainer) -> Dict[str, Any]:
    params = param_leaves(trainer)
    opt = list(named_leaves(trainer.opt_state))
    return {"param_names": [n for n, _ in params],
            "params": [t.detach().cpu() for _, t in params],
            "opt_names": [n for n, _ in opt],
            "opt_state": [t.detach().cpu() for _, t in opt],
            "step": int(trainer.step)}


def save_checkpoint(path, state, *, force: bool = True) -> None:
    """Writes the trainer ``state`` into the directory ``path`` (its
    ``state_name``: a sharded trainer its rank's shard); the file is
    complete when this returns (written aside, then renamed)."""
    path = _abs(path)
    target = os.path.join(path, state_name(state))
    if os.path.exists(target) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    os.makedirs(path, exist_ok=True)
    tmp = target + ".tmp"
    torch.save(_contents(state), tmp)
    os.replace(tmp, target)


def restore_checkpoint(path, like):
    """Restores a ``save_checkpoint`` directory into the trainer ``like``
    (the same configuration, sharded as it was) in place, on its devices,
    and returns it.  Nothing is copied unless every leaf matches in path and
    shape."""
    data = torch.load(os.path.join(_abs(path), state_name(like)), map_location="cpu",
                      weights_only=True)
    pairs = []
    for names_key, key, want in (("param_names", "params", param_leaves(like)),
                                 ("opt_names", "opt_state", list(named_leaves(like.opt_state)))):
        got_names, got = data[names_key], data[key]
        if got_names != [n for n, _ in want]:
            raise ValueError(f"checkpoint {key} leaves {got_names} != the trainer's "
                             f"{[n for n, _ in want]}")
        for (name, dst), src in zip(want, got):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint leaf {name} shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            pairs.append((dst, src))
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src.to(dst.dtype))
    like.step = int(data["step"])
    return like


class CheckpointManager:
    """Step-indexed checkpoints under one directory (``<dir>/<step>/``):
    saves on every ``save_interval_steps``-th step past the newest, and
    keeps the newest ``max_to_keep``.  A step counts where the file asked
    for (``state_name``: ``state.pt`` or a rank's shard) is there; a rank
    removes only its own files of old steps."""

    def __init__(self, directory, max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = _abs(directory)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self, name: str = _STATE_NAME) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, name)))

    def latest_step(self, name: str = _STATE_NAME) -> Optional[int]:
        steps = self.all_steps(name)
        return steps[-1] if steps else None

    def should_save(self, step: int, name: str = _STATE_NAME) -> bool:
        latest = self.latest_step(name)
        return (self.save_interval_steps > 0 and step % self.save_interval_steps == 0
                and (latest is None or step > latest))

    def save(self, step: int, state) -> bool:
        name = state_name(state)
        if not self.should_save(step, name):
            return False
        save_checkpoint(os.path.join(self.directory, str(step)), state)
        for old in self.all_steps(name)[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            old_dir = os.path.join(self.directory, str(old))
            if name == _STATE_NAME:
                shutil.rmtree(old_dir)
                continue
            os.remove(os.path.join(old_dir, name))
            try:
                os.rmdir(old_dir)   # the last rank's file removes the directory
            except OSError:
                pass
        return True

    def restore(self, step: int, like):
        return restore_checkpoint(os.path.join(self.directory, str(step)), like)


def make_manager(directory, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1) -> CheckpointManager:
    """A step-indexed manager: keeps the newest ``max_to_keep``, saves
    every ``save_interval_steps`` steps.  Saves are synchronous."""
    return CheckpointManager(directory, max_to_keep, save_interval_steps)


def save_step(manager: CheckpointManager, state, step: Optional[int] = None) -> bool:
    """Saves the trainer at its step (``trainer.step`` by default); False
    where the save interval skips it."""
    return manager.save(int(state.step) if step is None else int(step), state)


def restore_latest(manager: CheckpointManager, like) -> Optional[Any]:
    """Restores the newest step into ``like``; None if there is none."""
    step = manager.latest_step(state_name(like))
    return None if step is None else manager.restore(step, like)

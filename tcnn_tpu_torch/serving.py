"""Serving bundles and exported training steps.

PyTorch counterpart of ``tcnn_tpu/serving.py:54-281``.  The JAX package
serves a ``jax.export`` artifact per batch bucket.  ``torch.export``
cannot carry the port's kernels (pybind functions, not registered
operators), so the port's bundle holds what rebuilds the model instead:

  * ``meta.json``: the JAX bundle's keys (format version, dims, input
    dtype, batch buckets, ``platforms`` ``["cuda"]`` or ``["cpu"]``,
    hyperparams) plus the model's config and dtype policy;
  * ``params/<name>.npy``: the inference parameters, baked in: the
    optimizer's custom weights (EMA, Average; trainer.h:329-333) where it
    has them;
  * ``batch_<B>.json`` per bucket: the shapes and dtypes of the request
    that the loader captures, in place of the JAX bundle's per-bucket
    artifact.

``load_inference`` rebuilds the model through ``config.py`` with no
training config, trainer or optimizer state.  On the card it captures
one CUDA graph per bucket (one request at the smallest bucket first
fills the kernels' caches) and replays it per request: kernels G and M
launch once each per replay.  A request is padded with zero rows up to
the smallest bucket that fits and sliced back, the batch-granularity
trick of the reference's torch binding (modules.py:176-192).  A bundle
written on the CPU loads on the card, and the other way round.

    from tcnn_tpu_torch import serving
    serving.export_inference(model.trainer, "model.tcnnz",
                             batch_sizes=(1 << 14, 1 << 16, 1 << 18))
    srv = serving.load_inference("model.tcnnz")      # any process
    y = srv(x)                                       # (B, n_in) -> (B, n_out)

``export_train_step`` / ``load_train_step`` do the same for a training
step at one batch size: the artifact holds the whole training config,
the policy and the batch; the loaded ``step(state, x, target) ->
(state, loss)`` takes and returns the trainer dict of
``utils/serialization.py`` and replays a captured step on the card.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .common import Policy, resolve_device

_META_NAME = "meta.json"
_PARAMS_DIR = "params/"
_FORMAT_VERSION = 1
_TRAIN_STEP_KIND = "tcnn_tpu_torch.train_step"


def default_buckets(max_batch: int, min_batch: int = 256) -> Tuple[int, ...]:
    """Power-of-two bucket ladder [min_batch .. ≥max_batch]."""
    if max_batch < 1:
        raise ValueError("max_batch must be positive")
    if min_batch < 1:
        raise ValueError("min_batch must be positive")
    out = []
    b = int(min_batch)
    while True:
        out.append(b)
        if b >= max_batch:
            return tuple(out)
        b *= 2


def _encoding_config(enc) -> Dict[str, Any]:
    """An encoding's hyperparams with each Composite child's input slice,
    which rebuild it through ``config.create_encoding``."""
    cfg = enc.hyperparams()
    if cfg.get("otype") == "Composite":
        cfg["nested"] = [{**_encoding_config(e), "dims_to_encode_begin": begin,
                          "n_dims_to_encode": nd}
                         for e, (begin, nd) in zip(enc.nested, enc.slices)]
    return cfg


def model_config(model) -> Dict[str, Any]:
    """The config that rebuilds ``model`` (a NetworkWithInputEncoding)."""
    return {"n_input_dims": model.n_input_dims, "n_output_dims": model.n_output_dims,
            "encoding": _encoding_config(model.encoding),
            "network": model.network.hyperparams()}


def _policy_json(policy: Policy) -> Dict[str, str]:
    return {k: str(getattr(policy, k)).replace("torch.", "")
            for k in ("param_dtype", "compute_dtype", "output_dtype")}


def _policy_from_json(d: Dict[str, str]) -> Policy:
    return Policy(**{k: getattr(torch, v) for k, v in d.items()})


def _build_model(meta: Dict[str, Any], device):
    from .config import create_network_with_input_encoding

    cfg = meta["config"]
    return create_network_with_input_encoding(
        cfg["n_input_dims"], cfg["n_output_dims"], cfg["encoding"], cfg["network"],
        policy=_policy_from_json(meta["policy"]), device=device)


def _read(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def _write(path: Optional[str], data: bytes) -> bytes:
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def export_inference(trainer, path: Optional[str] = None, *,
                     batch_sizes: Sequence[int] = (1 << 14, 1 << 18),
                     input_dtype=torch.float32) -> bytes:
    """The trainer's inference function as a serving bundle: the
    inference parameters (custom weights where the optimizer has them)
    and the config that rebuilds the model, for the ascending
    ``batch_sizes``.  Returns the bytes (also written to ``path``).  A
    trainer holding sharded tables is refused
    (``utils.serialization.check_replicated``)."""
    from .utils.serialization import check_replicated

    check_replicated(trainer, "export_inference")
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"bad batch_sizes {batch_sizes}")
    model = trainer.model
    with torch.no_grad():
        params = {n: p.detach().float().cpu().numpy()
                  for n, p in trainer.inference_params().items()}
    meta = {
        "format_version": _FORMAT_VERSION,
        "n_input_dims": model.n_input_dims,
        "n_output_dims": model.n_output_dims,
        "input_dtype": str(input_dtype).replace("torch.", ""),
        "batch_sizes": batch_sizes,
        "platforms": [next(iter(trainer.params().values())).device.type],
        "hyperparams": model.hyperparams(),
        "config": model_config(model),
        "policy": _policy_json(trainer.policy),
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META_NAME, json.dumps(meta, indent=1))
        for b in batch_sizes:
            z.writestr(_bucket_name(b), json.dumps({
                "batch": b, "x": [b, model.n_input_dims, meta["input_dtype"]],
                "y": [b, model.n_output_dims, meta["policy"]["output_dtype"]]}))
        for name, value in params.items():
            npy = io.BytesIO()
            np.save(npy, value, allow_pickle=False)
            z.writestr(f"{_PARAMS_DIR}{name}.npy", npy.getvalue())
    return _write(path, buf.getvalue())


def _bucket_name(batch: int) -> str:
    return f"batch_{batch}.json"


class _BucketGraph:
    """One bucket's captured inference and its static buffers."""

    def __init__(self, graph, x, y):
        self.graph, self.x, self.y = graph, x, y


class ServingModel:
    """A loaded serving bundle: ``srv(x)`` for any batch up to the largest
    bucket, padded with zero rows up to the smallest bucket that fits and
    sliced back."""

    def __init__(self, meta: Dict[str, Any], params: Dict[str, np.ndarray],
                 buckets: Sequence[int], device=None):
        self.meta = meta
        self.device = resolve_device(device)
        self.n_input_dims = int(meta["n_input_dims"])
        self.n_output_dims = int(meta["n_output_dims"])
        self.batch_sizes = sorted(int(b) for b in meta["batch_sizes"])
        missing = set(self.batch_sizes) - set(buckets)
        if missing:
            raise ValueError(
                f"bundle meta lists buckets {self.batch_sizes} but is "
                f"missing artifacts for {sorted(missing)} — truncated or "
                "hand-assembled bundle")
        self.platforms = tuple(meta.get("platforms", ()))
        self._input_dtype = getattr(torch, meta.get("input_dtype", "float32"))
        self.model = _build_model(meta, self.device)
        named = dict(self.model.named_parameters())
        if set(params) != set(named):
            raise ValueError(f"bundle parameters {sorted(params)} != the model's "
                             f"{sorted(named)}")
        with torch.no_grad():
            for name, p in named.items():
                if tuple(params[name].shape) != tuple(p.shape):
                    raise ValueError(f"bundle parameter {name} shape "
                                     f"{params[name].shape} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(params[name], np.float32)))
        self.model.requires_grad_(False)
        self._graphs: Dict[int, _BucketGraph] = {}
        if self.device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        """One request at the smallest bucket on a side stream fills the
        kernels' caches; then each bucket's request is captured."""
        dev, model = self.device, self.model
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            model.inference(torch.zeros((self.batch_sizes[0], self.n_input_dims),
                                        dtype=self._input_dtype, device=dev))
        torch.cuda.current_stream(dev).wait_stream(side)
        for b in self.batch_sizes:
            x = torch.zeros((b, self.n_input_dims), dtype=self._input_dtype, device=dev)
            graph = torch.cuda.CUDAGraph()
            with torch.inference_mode(), torch.cuda.graph(graph):
                y = model.inference(x)
            self._graphs[b] = _BucketGraph(graph, x, y)

    def bucket_for(self, batch: int) -> int:
        for b in self.batch_sizes:
            if batch <= b:
                return b
        raise ValueError(
            f"batch {batch} exceeds the largest exported bucket "
            f"{self.batch_sizes[-1]} — split the request or re-export "
            f"with a larger bucket")

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device, self._input_dtype)
        if x.dim() != 2 or x.shape[1] != self.n_input_dims:
            raise ValueError(f"expected (B, {self.n_input_dims}) input, got "
                             f"{tuple(x.shape)}")
        b = x.shape[0]
        bucket = self.bucket_for(b)
        if self.device.type != "cuda":
            xp = torch.zeros((bucket, self.n_input_dims), dtype=x.dtype)
            xp[:b] = x
            with torch.inference_mode():
                return self.model.inference(xp)[:b]
        cap = self._graphs[bucket]
        cap.x[:b].copy_(x)
        cap.x[b:].zero_()
        cap.graph.replay()
        return cap.y[:b].clone()


def load_inference(path_or_bytes, device=None) -> ServingModel:
    """A serving bundle written by ``export_inference``, on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    with zipfile.ZipFile(io.BytesIO(_read(path_or_bytes)), "r") as z:
        meta = json.loads(z.read(_META_NAME).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported bundle format {meta.get('format_version')}")
        params = {name[len(_PARAMS_DIR):-len(".npy")]:
                  np.load(io.BytesIO(z.read(name)), allow_pickle=False)
                  for name in z.namelist()
                  if name.startswith(_PARAMS_DIR) and name.endswith(".npy")}
        buckets = [json.loads(z.read(name).decode())["batch"] for name in z.namelist()
                   if name.startswith("batch_") and name.endswith(".json")]
    return ServingModel(meta, params, buckets, device)


# ---------------------------------------------------------------------------
# Exported training step (tcnn_tpu/serving.py:212-281).
# ---------------------------------------------------------------------------


def export_train_step(trainer, batch: int, path: Optional[str] = None, *,
                      input_dtype=torch.float32) -> bytes:
    """``(state, x, target) -> (state, loss)`` at a static batch size, as
    a JSON artifact: the training config (model, loss, optimizer), the
    policy, the seed and the batch.  The state stays an argument, the
    trainer dict of ``utils/serialization.py``.  Returns the bytes (also
    written to ``path``); load with ``load_train_step``."""
    model = trainer.model
    meta = {
        "format_version": _FORMAT_VERSION,
        "kind": _TRAIN_STEP_KIND,
        "batch": int(batch),
        "n_input_dims": model.n_input_dims,
        "n_output_dims": model.n_output_dims,
        "input_dtype": str(input_dtype).replace("torch.", ""),
        "platforms": [next(iter(trainer.params().values())).device.type],
        "config": {**model_config(model), "loss": trainer.loss.hyperparams(),
                   "optimizer": trainer.optimizer.hyperparams()},
        "policy": _policy_json(trainer.policy),
        "seed": trainer.seed,
        "perturbation_sigma": trainer.perturbation_sigma,
    }
    return _write(path, json.dumps(meta, indent=1).encode())


class TrainStep:
    """A loaded ``export_train_step`` artifact: ``step(state, x, target)
    -> (state, loss)``.  Each call loads ``state`` into its own trainer,
    takes one step through ``Trainer.make_training_step`` (on the card, the
    replay of a step captured on the first call; JAX's
    ``export_train_step`` jits ``step_fn``) and returns the trainer dict after it."""

    def __init__(self, meta: Dict[str, Any], device=None):
        from .config import create_from_config

        self.meta = meta
        self.batch = int(meta["batch"])
        self._input_dtype = getattr(torch, meta.get("input_dtype", "float32"))
        cfg = meta["config"]
        self.model = create_from_config(
            cfg["n_input_dims"], cfg["n_output_dims"], cfg,
            policy=_policy_from_json(meta["policy"]), seed=int(meta["seed"]), device=device)
        self.trainer = self.model.trainer
        self.trainer.perturbation_sigma = meta.get("perturbation_sigma")
        self.device = next(iter(self.trainer.params().values())).device
        self._step = self.trainer.make_training_step()

    def __call__(self, state: Dict[str, Any], x, target):
        shapes = {"x": (x, self.meta["n_input_dims"]), "target": (target, self.meta["n_output_dims"])}
        for what, (t, dims) in shapes.items():
            if tuple(t.shape) != (self.batch, dims):
                raise ValueError(f"{what}: expected ({self.batch}, {dims}), got "
                                 f"{tuple(t.shape)}")
        x = torch.as_tensor(x).to(self.device, self._input_dtype)
        target = torch.as_tensor(target).to(self.device, self._input_dtype)
        self.trainer.deserialize(state)
        loss = self._step(x, target)
        return self.trainer.serialize(), loss


def load_train_step(path_or_bytes, device=None) -> TrainStep:
    """An ``export_train_step`` artifact as ``step(state, x, target) ->
    (state, loss)`` on ``device`` (``cuda`` unless the caller asks for the
    CPU), with no model code or config of the caller's."""
    meta = json.loads(_read(path_or_bytes).decode())
    if meta.get("kind") != _TRAIN_STEP_KIND or meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(f"not a train-step artifact of format {_FORMAT_VERSION}: "
                         f"kind {meta.get('kind')!r}, format {meta.get('format_version')}")
    return TrainStep(meta, device)

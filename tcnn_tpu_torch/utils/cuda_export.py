"""Exporter to the CUDA original's (tiny-cuda-nn) snapshot format.

PyTorch counterpart of ``tcnn_tpu/utils/cuda_export.py:38-167``, the
inverse of ``cuda_import``: the nlohmann JSON-with-binary structure of
``Trainer::serialize`` (trainer.h:275-287) and Adam's ``serialize``
(adam.h:278-287).

The buffer (network_with_input_encoding.h:115-130): the network's weight
matrices, each ROW-MAJOR (out, in) with the reference's 16-wide padding
put back as zeros (the importer's strict check wants padded columns zero,
so export → import keeps every bit), then the encoding's parameters
flat, in the JAX tree's leaf order.  For the same parameters the bytes
equal the JAX package's.

Two forms on disk, as nlohmann writes them: msgpack with native bin
values (``json::to_msgpack``; the port's own codec, ``utils/msgpack.py``),
or text JSON with binary values rendered ``{"bytes": [...],
"subtype": null}``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from . import msgpack
from .cuda_import import _encoding_params, _parts, _ref_matrix_dims


def _export_matrix(ours: np.ndarray, ref_shape, dtype=np.float32) -> np.ndarray:
    """The port's (in, out) matrix → the reference's RM (out_pad, in_pad),
    flat, zero-padded."""
    rows, cols = ref_shape
    ours = np.asarray(ours, dtype)
    in_dim, out_dim = ours.shape
    m = np.zeros((rows, cols), dtype)
    m[:out_dim, :in_dim] = ours.T
    return m.reshape(-1)


def _np(t: torch.Tensor, dtype) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype)


def _flatten_reference_layout(model, tree: Dict[str, torch.Tensor],
                              dtype=np.float32) -> np.ndarray:
    """{port parameter name: tensor} → the reference's flat buffer.
    Integer state (Adam's step counters) is flattened with
    ``dtype=np.uint32``, so counters above 2^24 keep their values."""
    network, prefix, _ = _parts(model)
    parts = [_export_matrix(_np(tree[f"{prefix}layers.{i}"], dtype), ref, dtype)
             for i, ref in enumerate(_ref_matrix_dims(network))]
    parts += [_np(tree[name], dtype).reshape(-1) for name in _encoding_params(model)]
    return np.concatenate(parts) if parts else np.zeros((0,), dtype)


def export_snapshot(trainer, serialize_optimizer: bool = False,
                    params_type: str = "float") -> Dict[str, Any]:
    """The trainer → a reference-format snapshot dict (binary values as
    ``bytes``; ``save_snapshot`` writes it).  A trainer holding sharded
    tables is refused (``serialization.check_replicated``)."""
    from .serialization import check_replicated

    check_replicated(trainer, "export_snapshot")
    flat = _flatten_reference_layout(trainer.model, trainer.params())
    if params_type == "float":
        blob = flat.astype("<f4").tobytes()
    elif params_type == "__half":
        blob = flat.astype("<f2").tobytes()
    else:
        raise ValueError(f"unknown params_type {params_type!r}")
    data: Dict[str, Any] = {"n_params": int(flat.size), "params_type": params_type,
                            "params_binary": blob}
    if serialize_optimizer:
        # Down through wrapper optimizers (EMA, Average, ...) to the Adam
        # core, as the reference's nested serialize does (ema.h).
        st, opt_obj = trainer.opt_state, trainer.optimizer
        while isinstance(st, dict) and "nested" in st and not {"mu", "nu"} <= set(st):
            st = st["nested"]
            opt_obj = getattr(opt_obj, "_nested", opt_obj)
        if not (isinstance(st, dict) and {"mu", "nu"} <= set(st)):
            raise ValueError(
                "optimizer state is not Adam-shaped (mu/nu); only Adam "
                "snapshots exist in the reference format (adam.h:278-287)")
        opt: Dict[str, Any] = {
            "current_step": int(st["step"]) if "step" in st else int(trainer.step),
            "base_learning_rate": float(opt_obj.learning_rate),
            "first_moments_binary":
                _flatten_reference_layout(trainer.model, st["mu"]).astype("<f4").tobytes(),
            "second_moments_binary":
                _flatten_reference_layout(trainer.model, st["nu"]).astype("<f4").tobytes(),
        }
        if "param_steps" in st:
            ps = _flatten_reference_layout(trainer.model, st["param_steps"], dtype=np.uint32)
            opt["param_steps_binary"] = ps.astype("<u4").tobytes()
        data["optimizer"] = opt
    return data


def _to_text_json(data):
    """Binary values as nlohmann prints them in text JSON."""
    if isinstance(data, bytes):
        return {"bytes": list(data), "subtype": None}
    if isinstance(data, dict):
        return {k: _to_text_json(v) for k, v in data.items()}
    if isinstance(data, list):
        return [_to_text_json(v) for v in data]
    return data


def save_snapshot(path, data: Dict[str, Any], form: str = "msgpack") -> None:
    """Writes an ``export_snapshot`` dict.  form="msgpack" (default): what
    nlohmann's ``json::from_msgpack``, and so the CUDA original's
    ``Trainer::deserialize``, reads.  form="json": text JSON in nlohmann's
    binary rendering, which ``cuda_import`` reads (nlohmann's
    ``json::parse`` does not turn it back into binary values)."""
    if form == "json":
        with open(path, "w") as f:
            json.dump(_to_text_json(data), f)
    elif form == "msgpack":
        with open(path, "wb") as f:
            f.write(msgpack.packb(data))
    else:
        raise ValueError(f"unknown form {form!r}")

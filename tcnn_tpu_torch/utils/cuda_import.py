"""Importer for the CUDA original's (tiny-cuda-nn) training snapshots.

PyTorch counterpart of ``tcnn_tpu/utils/cuda_import.py:44-254``.  The
reference's ``Trainer::serialize`` (trainer.h:275-315) writes nlohmann
JSON with binary values (gpu_memory_json.h:37-72):

    {"n_params": N, "params_type": "__half"|"float",
     "params_binary": <bytes>,
     "optimizer": {"current_step": s, "base_learning_rate": lr,
                   "first_moments_binary": <f32 bytes>,
                   "second_moments_binary": <f32 bytes>,
                   "param_steps_binary": <u32 bytes>}}   # adam.h:278-299

Text JSON renders a binary value as ``{"bytes": [..], "subtype": null}``;
a msgpack dump holds it natively, and is decoded by the port's own codec
(``utils/msgpack.py``), so no ``msgpack`` package is needed.

The parameter buffer is ``[network][encoding]``
(network_with_input_encoding.h:115-130): the network's matrices one after
another, each ROW-MAJOR (out, in) with the reference's 16-wide padding
(fully_fused_mlp.cu:855-878), then the encoding's parameters flat, in the
JAX tree's leaf order.  The port keeps (in, out) matrices, as the JAX
package does, so each is transposed and cut free of its padding.
"""

from __future__ import annotations

import json
import warnings
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..common import HashType, next_multiple
from ..optimizers.base import jax_order
from . import msgpack
from .serialization import copy_leaves

# The reference's tensor-core alignment of network input and output
# widths (src/network.cu:76-95 minimum_alignment).
_REF_WIDTH_ALIGNMENT = 16


def load_snapshot(path_or_data) -> Dict[str, Any]:
    """A reference snapshot from a path (text JSON or msgpack), raw bytes
    or an already parsed dict."""
    if isinstance(path_or_data, dict):
        return path_or_data
    if isinstance(path_or_data, (bytes, bytearray)):
        raw = bytes(path_or_data)
    else:
        with open(path_or_data, "rb") as f:
            raw = f.read()
    try:
        return json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return msgpack.unpackb(raw)


def _binary_to_np(value, dtype) -> np.ndarray:
    """A nlohmann binary value (either form) as a numpy array."""
    if isinstance(value, dict) and "bytes" in value:
        raw = bytes(bytearray(int(b) & 0xFF for b in value["bytes"]))
    elif isinstance(value, (bytes, bytearray)):
        raw = bytes(value)
    elif isinstance(value, list):  # a plain array of byte values
        raw = bytes(bytearray(int(b) & 0xFF for b in value))
    else:
        raise ValueError(f"unsupported binary encoding: {type(value)}")
    return np.frombuffer(raw, dtype=dtype)


def _parts(model) -> Tuple[Any, str, Any]:
    """(network, its name prefix, encoding or None)."""
    network = getattr(model, "network", model)
    encoding = getattr(model, "encoding", None)
    return network, "network." if network is not model else "", encoding


def _ref_matrix_dims(network) -> List[Tuple[int, int]]:
    """(rows, cols) of each reference weight matrix, padding included
    (fully_fused_mlp.cu:866-878 / cutlass_mlp.h:114-120)."""
    in_pad = next_multiple(network.n_input_dims, _REF_WIDTH_ALIGNMENT)
    out_pad = next_multiple(network.n_output_dims, _REF_WIDTH_ALIGNMENT)
    w, h = network.n_neurons, network._n_hidden_layers
    if h == 0:
        return [(out_pad, in_pad)]
    return [(w, in_pad)] + [(w, w)] * (h - 1) + [(out_pad, w)]


def _import_matrix(flat: np.ndarray, ours_shape, ref_shape, name: str,
                   strict: bool) -> np.ndarray:
    """One RM (out, in) reference matrix → the port's (in, out), padding
    cut.  ``strict``: the dropped input columns must be zero, since
    nonzero weights there would change the function (moments and step
    counters on padded lanes are simply dropped)."""
    rows, cols = ref_shape
    m = flat.reshape(rows, cols)
    ours_in, ours_out = ours_shape
    if cols < ours_in or rows < ours_out:
        raise ValueError(f"{name}: reference matrix {ref_shape} smaller than model "
                         f"matrix {ours_shape}")
    dropped_in = m[:, ours_in:]
    if strict and dropped_in.size and np.abs(dropped_in).max() > 0:
        raise ValueError(
            f"{name}: reference snapshot has nonzero weights on padded "
            f"input columns [{ours_in}:{cols}) — the padded features "
            "act as biases and cannot be dropped faithfully")
    return np.ascontiguousarray(m[:ours_out, :ours_in].T)


def _encoding_params(model) -> Dict[str, torch.Tensor]:
    network, prefix, encoding = _parts(model)
    if encoding is None:
        return {}
    named = dict(encoding.named_parameters())
    return {f"encoding.{n}": named[n] for n in jax_order(named)}


def _split_buffer(model, flat: np.ndarray, strict: bool = True) -> Dict[str, np.ndarray]:
    """A reference-layout flat buffer → {port parameter name: array}."""
    network, prefix, encoding = _parts(model)
    out, pos = {}, 0
    for i, (ref, ours) in enumerate(zip(_ref_matrix_dims(network), network._layer_dims())):
        n = ref[0] * ref[1]
        out[f"{prefix}layers.{i}"] = _import_matrix(flat[pos:pos + n], ours, ref,
                                                    f"layer {i}", strict)
        pos += n
    enc = _encoding_params(model)
    n_enc = sum(p.numel() for p in enc.values())
    if pos + n_enc != flat.size:
        raise ValueError(f"snapshot has {flat.size} params; model needs {pos + n_enc} "
                         f"(network {pos} + encoding {n_enc})")
    for name, p in enc.items():
        out[name] = flat[pos:pos + p.numel()].reshape(tuple(p.shape))
        pos += p.numel()
    return out


def _copy_into(tensors: Dict[str, torch.Tensor], values: Dict[str, np.ndarray]) -> None:
    copy_leaves([(n, tensors[n]) for n in values], list(values.values()))


def import_params(model, snapshot) -> Dict[str, torch.Tensor]:
    """Loads a reference snapshot's parameters into ``model`` (a
    NetworkWithInputEncoding or a bare network) in place, and returns
    its parameters by name."""
    data = load_snapshot(snapshot)
    ptype = data.get("params_type", "float")
    dtype = {"float": np.float32, "__half": np.float16}.get(ptype)
    if dtype is None:
        raise ValueError(f"unknown params_type {ptype!r}")
    flat = _binary_to_np(data["params_binary"], dtype).astype(np.float32)
    if "n_params" in data and int(data["n_params"]) != flat.size:
        raise ValueError(f"n_params={data['n_params']} but binary holds {flat.size}")
    values = _split_buffer(model, flat)
    _warn_nonreference_hash(model)
    params = dict(model.named_parameters())
    _copy_into(params, values)
    return params


def _warn_nonreference_hash(model) -> None:
    """Warns where a grid uses a hash the reference does not implement
    (CoherentAdd): the table is copied as it is, but its rows are looked
    up elsewhere, so the model computes another function.  Reference
    snapshots belong in CoherentPrime/Prime configs
    (common_device.h:648-707)."""
    ref_hashes = {HashType.PRIME, HashType.COHERENT_PRIME,
                  HashType.REVERSED_PRIME, HashType.RNG}
    for mod in model.modules():
        spec = getattr(mod, "spec", None)
        if spec is not None and any(lv.use_hash for lv in spec.levels) \
                and spec.hash_type not in ref_hashes:
            warnings.warn(
                f"importing a reference CUDA snapshot into a grid with "
                f"hash={spec.hash_type.value!r}, which the reference "
                f"does not implement: hash-level lookups will differ "
                f"from the snapshot's producer. Use a CoherentPrime/"
                f"Prime config for reference snapshots.", stacklevel=3)


def import_trainer_state(trainer, snapshot) -> None:
    """A reference snapshot into ``trainer`` in place: the parameters and,
    where present and the optimizer is Adam-shaped, the first and second
    moments, the per-element step counters and the global step
    (adam.h:278-299)."""
    data = load_snapshot(snapshot)
    import_params(trainer.model, data)
    opt, st = data.get("optimizer"), trainer.opt_state
    if not (opt and isinstance(st, dict) and {"mu", "nu"} <= set(st)):
        return

    def split(key, dtype):
        return _split_buffer(trainer.model, _binary_to_np(opt[key], dtype), strict=False)

    _copy_into(st["mu"], split("first_moments_binary", np.float32))
    _copy_into(st["nu"], split("second_moments_binary", np.float32))
    if "param_steps_binary" in opt and "param_steps" in st:
        _copy_into(st["param_steps"], split("param_steps_binary", np.uint32))
    if "current_step" in opt and "step" in st:
        st["step"].fill_(int(opt["current_step"]))

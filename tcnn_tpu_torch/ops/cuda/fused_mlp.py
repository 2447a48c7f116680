"""Kernel M wrapper: fused-MLP forward (``csrc/fused_mlp.cu``).

Replaces ``tcnn_tpu/ops/pallas/fused_mlp.py::_fwd_kernel``.  A CUDA
tensor launches the kernel; a CPU tensor takes ``fused_mlp_plain``, the
same function in plain PyTorch (``_jnp_mlp_ref`` of the JAX package),
which the CPU tests and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...common import Activation
from ..activations import apply_activation
from . import kernels, require_cuda_tensors, require_no_grad

SUPPORTED_WIDTHS = (16, 32, 64, 128)
MAX_LAYERS = 32   # csrc/fused_mlp.cu: kMaxLayers


def fused_mlp_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                    activation: Activation, output_activation: Activation,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    output_dtype: torch.dtype = torch.float32,
                    input_soa: bool = False,
                    output_soa: bool = False) -> torch.Tensor:
    """The bias-free chain y = out_act(act(act(x W_0) W_1 ...) W_out).

    Operands are rounded to ``compute_dtype``, each product is summed in
    fp32 (JAX's ``preferred_element_type=f32``: products of bf16 values
    are exact in fp32), the activation runs in fp32 and the result is
    rounded to ``compute_dtype`` between layers, as in _fwd_kernel.  On a
    CUDA device the caller disables TF32 where this is a reference.
    """
    h = (x.t() if input_soa else x).to(compute_dtype)
    for w in weights[:-1]:
        z = h.float() @ w.to(compute_dtype).float()
        h = apply_activation(z, activation).to(compute_dtype)
    z = h.float() @ weights[-1].to(compute_dtype).float()
    y = apply_activation(z, output_activation).to(output_dtype)
    return y.t() if output_soa else y


def fused_mlp_fwd(weights: Sequence[torch.Tensor], x: torch.Tensor,
                  activation: Activation, output_activation: Activation,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  output_dtype: torch.dtype = torch.float32,
                  input_soa: bool = False,
                  output_soa: bool = False) -> torch.Tensor:
    """The whole MLP in one kernel launch.

    weights: [(D_in, W), (W, W) × (n_hidden − 1), (W, D_out)], W in
    {16, 32, 64, 128}, n_hidden ≥ 1.  x: (B, D_in), or (D_in, B) with
    ``input_soa``.  Returns (B, D_out), or (D_out, B) with ``output_soa``.
    """
    if x.device.type == "cpu":
        return fused_mlp_plain(weights, x, activation, output_activation,
                               compute_dtype, output_dtype, input_soa,
                               output_soa)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_fwd: unsupported device {x.device}")
    name = "fused_mlp_fwd"
    require_no_grad(name, x, *weights)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} is not supported")
    if output_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: output dtype {output_dtype} is not supported")
    if not 2 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"{name}: needs 2 to {MAX_LAYERS} layers, got {len(weights)}")
    w_in, *w_mid, w_out = weights
    d_in, width = w_in.shape
    d_out = w_out.shape[1]
    if width not in SUPPORTED_WIDTHS:
        raise ValueError(f"{name}: width {width} not in {SUPPORTED_WIDTHS}")
    if any(w.shape != (width, width) for w in w_mid) or w_out.shape[0] != width:
        raise ValueError(f"{name}: layer shapes {[tuple(w.shape) for w in weights]}")
    if x.ndim != 2 or x.shape[0 if input_soa else 1] != d_in:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match "
                         f"D_in={d_in} (input_soa={input_soa})")

    x = x.to(compute_dtype).contiguous()
    ws = [w.to(compute_dtype).contiguous() for w in weights]
    require_cuda_tensors(name, x, *ws)

    B = x.shape[1] if input_soa else x.shape[0]
    y = torch.empty((d_out, B) if output_soa else (B, d_out),
                    dtype=output_dtype, device=x.device)
    if B == 0:
        return y
    xs_b, xs_d = (1, B) if input_soa else (d_in, 1)
    ys_b, ys_d = (1, B) if output_soa else (d_out, 1)
    acts = list(Activation)
    kernels().fused_mlp_fwd(x, xs_b, xs_d, ws, y, ys_b, ys_d,
                            acts.index(activation),
                            acts.index(output_activation), input_soa,
                            output_soa)
    fused_mlp_fwd.launches += 1
    return y


fused_mlp_fwd.launches = 0

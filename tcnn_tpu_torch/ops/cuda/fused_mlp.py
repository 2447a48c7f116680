"""Wrappers of kernels M and MB: fused-MLP forward (``csrc/fused_mlp.cu``)
and backward (``csrc/fused_mlp_bwd.cu``), and ``FusedMLPFunction`` and
``FusedMLPBackwardFunction``, which join them for autograd, second order
included.

M replaces ``tcnn_tpu/ops/pallas/fused_mlp.py::_fwd_kernel``, MB
``::_bwd_kernel``.  A CUDA tensor launches the kernel; a CPU tensor takes
``fused_mlp_plain`` / ``fused_mlp_bwd_plain``, the same functions in
plain PyTorch, which the CPU tests and ``chip_smoke.py`` hold the kernels
against.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ...common import Activation
from ..activations import activation_derivative, apply_activation
from . import kernels, require_cuda_tensors

SUPPORTED_WIDTHS = (16, 32, 64, 128)
MAX_LAYERS = 32   # csrc/mlp_common.cuh: kMaxLayers
MAX_SMEM = 232448   # shared memory one CTA may use on sm_90


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


def _check_args(name: str, weights: Sequence[torch.Tensor], x: torch.Tensor,
                compute_dtype: torch.dtype, input_soa: bool) -> Tuple[int, int]:
    """What the kernels M and MB take; returns (D_in, D_out)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} is not supported")
    if not 2 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"{name}: needs 2 to {MAX_LAYERS} layers, got {len(weights)}")
    w_in, *w_mid, w_out = weights
    d_in, width = w_in.shape
    if width not in SUPPORTED_WIDTHS:
        raise ValueError(f"{name}: width {width} not in {SUPPORTED_WIDTHS}")
    if any(w.shape != (width, width) for w in w_mid) or w_out.shape[0] != width:
        raise ValueError(f"{name}: layer shapes {[tuple(w.shape) for w in weights]}")
    if x.ndim != 2 or x.shape[0 if input_soa else 1] != d_in:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match "
                         f"D_in={d_in} (input_soa={input_soa})")
    return d_in, w_out.shape[1]


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
    if output_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: output dtype {output_dtype} is not supported")
    d_in, d_out = _check_args(name, weights, x, compute_dtype, input_soa)

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


def fused_mlp_bwd_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                        g: torch.Tensor, activation: Activation,
                        output_activation: Activation,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        input_soa: bool = False, output_soa: bool = False
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of kernel MB, step for step as _bwd_kernel
    (fused_mlp.py:113-198 of the JAX package): the forward recomputed with
    the rounding of ``fused_mlp_plain``; dz = g · out_act'(z_out) rounded
    to ``compute_dtype``; per layer, from the last, dW = hᵀ dz and
    dh = dz Wᵀ in fp32, then dz = dh · act'(z) rounded.  Returns the
    weight gradients in fp32 and dx in x's dtype and layout.  It is not
    autograd of ``fused_mlp_plain``, which would round elsewhere."""
    cdt = compute_dtype
    ws = [w.to(cdt).float() for w in weights]
    hs = [(x.t() if input_soa else x).to(cdt).float()]   # the input of each layer
    zs = []
    for w in ws[:-1]:
        zs.append(hs[-1] @ w)
        hs.append(apply_activation(zs[-1], activation).to(cdt).float())
    z_out = hs[-1] @ ws[-1]
    gg = (g.t() if output_soa else g).float()
    dz = (gg * activation_derivative(z_out, output_activation)).to(cdt).float()
    dws = [None] * len(ws)
    for i in range(len(ws) - 1, -1, -1):
        if i < len(ws) - 1:
            dz = (dh * activation_derivative(zs[i], activation)).to(cdt).float()
        dws[i] = hs[i].t() @ dz
        dh = dz @ ws[i].t()
    dx = (dh.t() if input_soa else dh).to(x.dtype)
    return dws, dx


def _max_hidden(d_in: int, d_out: int, width: int, bf16: bool, act: int,
                out_act: int) -> int:
    """The most hidden layers whose kernel-MB layout fits in MAX_SMEM at
    these widths and activations (every hidden h_k of a tile stays in
    shared memory, csrc/fused_mlp_bwd.cu: bwd_tile_rows)."""
    n = 1
    while n + 2 <= MAX_LAYERS and kernels().fused_mlp_bwd_smem_bytes(
            d_in, d_out, width, n + 2, bf16, act, out_act) <= MAX_SMEM:
        n += 1
    return n


def fused_mlp_bwd(weights: Sequence[torch.Tensor], x: torch.Tensor,
                  g: torch.Tensor, activation: Activation,
                  output_activation: Activation,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  input_soa: bool = False, output_soa: bool = False
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The whole MLP backward in one kernel launch (and a small reduction).

    weights, x, layouts: as for ``fused_mlp_fwd``.  g: the output gradient,
    (B, D_out), or (D_out, B) with ``output_soa``, any strides.  Returns
    ([dW per layer] float32, dx in x's dtype and layout).
    """
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(weights, x, g, activation, output_activation,
                                   compute_dtype, input_soa, output_soa)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: unsupported device {x.device}")
    name = "fused_mlp_bwd"
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: input dtype {x.dtype} is not supported")
    d_in, d_out = _check_args(name, weights, x, compute_dtype, input_soa)
    B = x.shape[1] if input_soa else x.shape[0]
    if g.shape != ((d_out, B) if output_soa else (B, d_out)):
        raise ValueError(f"{name}: output gradient {tuple(g.shape)} does not match "
                         f"B={B}, D_out={d_out} (output_soa={output_soa})")
    width = weights[0].shape[1]
    bf16 = compute_dtype == torch.bfloat16
    acts = list(Activation)
    act, out_act = acts.index(activation), acts.index(output_activation)
    smem = kernels().fused_mlp_bwd_smem_bytes(d_in, d_out, width, len(weights), bf16, act,
                                              out_act)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"{name}: {len(weights)} layers of width {width} need {smem} bytes of "
            f"shared memory per CTA, more than the {MAX_SMEM} an SM offers; at "
            f"{d_in} -> {width} -> {d_out}, {activation.value}, {compute_dtype}, kernel MB "
            f"takes at most {_max_hidden(d_in, d_out, width, bf16, act, out_act)} hidden "
            f"layers")

    xc = x.to(compute_dtype).contiguous()
    ws = [w.to(compute_dtype).contiguous() for w in weights]
    gf = g.float()
    require_cuda_tensors(name, xc, gf, *ws)
    sizes = [w.numel() for w in weights]
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty((d_in, B) if input_soa else (B, d_in), dtype=x.dtype,
                     device=x.device)
    if B == 0:
        dw.zero_()
    else:
        xs_b, xs_d = (1, B) if input_soa else (d_in, 1)
        gs_b, gs_d = (gf.stride(1), gf.stride(0)) if output_soa else gf.stride()
        kernels().fused_mlp_bwd(xc, xs_b, xs_d, ws, gf, gs_b, gs_d, dx, xs_b, xs_d,
                                dw, B, act, out_act, input_soa)
        fused_mlp_bwd.launches += 1
    dws = [d.view(w.shape) for d, w in zip(dw.split(sizes), weights)]
    return dws, dx


fused_mlp_bwd.launches = 0


def fused_mlp_bwd_bwd_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                            g: torch.Tensor, ct_dx: Optional[torch.Tensor],
                            ct_dws: Sequence[Optional[torch.Tensor]],
                            activation: Activation, output_activation: Activation,
                            compute_dtype: torch.dtype, output_dtype: torch.dtype,
                            input_soa: bool = False, output_soa: bool = False):
    """The backward of the MLP backward: given the cotangents of its
    outputs (dx and each dW; None for none), the gradients of
    ⟨(dx, dW), (ct_dx, ct_dW)⟩ in x, g and the weights.  Autograd of the
    autograd of ``fused_mlp_plain``, as the JAX package derives
    ``_fused_mlp_bwd_op``'s VJP from ``_jnp_mlp_ref``
    (``tcnn_tpu/ops/pallas/fused_mlp.py:334-347``): products by
    ``torch.matmul`` outside any kernel.  Returns (d_x, d_g, [d_W]), None
    where a gradient is zero by construction."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        gg = g.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in weights]
        y = fused_mlp_plain(ws, xx, activation, output_activation, compute_dtype,
                            output_dtype, input_soa, output_soa)
        first = torch.autograd.grad(y, [xx, *ws], grad_outputs=gg.to(y.dtype),
                                    create_graph=True)
        pairs = [(f, c.to(f.dtype)) for f, c in zip(first, (ct_dx, *ct_dws))
                 if c is not None and f.requires_grad]
        if not pairs:
            return None, None, [None] * len(ws)
        d_x, d_g, *d_ws = torch.autograd.grad(
            [f for f, _ in pairs], [xx, gg, *ws], grad_outputs=[c for _, c in pairs],
            allow_unused=True)
    return d_x, d_g, d_ws


class FusedMLPFunction(torch.autograd.Function):
    """The fused MLP with its explicit backward, the counterpart of
    ``_fused_mlp``'s custom VJP (``tcnn_tpu/ops/pallas/fused_mlp.py:228-233,
    :276-284, :353-357``).  It saves the input and the fp32 master weights
    and the backward recomputes the activations, as _bwd_kernel does.  The
    weight gradients come back in fp32, the masters' dtype; dx in x's
    dtype, computed in fp32 and cast once (:416-420).  Under
    ``create_graph`` the backward is ``FusedMLPBackwardFunction``, so it
    can be differentiated once more."""

    @staticmethod
    def forward(ctx, x, activation, output_activation, compute_dtype,
                output_dtype, input_soa, output_soa, *weights):
        ctx.set_materialize_grads(False)   # no gradient in, no kernel launched
        ctx.args = (activation, output_activation, compute_dtype, output_dtype,
                    input_soa, output_soa)
        ctx.save_for_backward(x, *weights)
        return fused_mlp_fwd(list(weights), x, activation, output_activation,
                             compute_dtype, output_dtype, input_soa, output_soa)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:   # one None per input: x, the six flags, the weights
            return (None,) * (6 + len(ctx.saved_tensors))
        x, *weights = ctx.saved_tensors
        act, out_act, cdt, odt, soa_in, soa_out = ctx.args
        if torch.is_grad_enabled():
            dx, *dws = FusedMLPBackwardFunction.apply(x, dy, *ctx.args, *weights)
        else:
            dws, dx = fused_mlp_bwd(weights, x, dy, act, out_act, cdt, soa_in, soa_out)
            dws = [d.to(w.dtype) for d, w in zip(dws, weights)]
        return (dx if ctx.needs_input_grad[0] else None,
                None, None, None, None, None, None, *dws)


class FusedMLPBackwardFunction(torch.autograd.Function):
    """The MLP backward ``(x, g, W) → (dx, dW)`` as a differentiable
    function, the counterpart of ``_fused_mlp_bwd_op``
    (``tcnn_tpu/ops/pallas/fused_mlp.py:307-350``).  Forward: kernel MB.
    Backward: ``fused_mlp_bwd_bwd_plain``, autograd of autograd of the
    plain chain, which recomputes the activations: like
    ``FusedMLPFunction`` it saves only x, g and the weights (x is the
    forward's own tensor, not a second copy).  A third derivative raises
    ``NotImplementedError`` (ROADMAP.md)."""

    @staticmethod
    def forward(ctx, x, g, activation, output_activation, compute_dtype,
                output_dtype, input_soa, output_soa, *weights):
        ctx.set_materialize_grads(False)
        ctx.args = (activation, output_activation, compute_dtype, output_dtype,
                    input_soa, output_soa)
        ctx.save_for_backward(x, g, *weights)
        dws, dx = fused_mlp_bwd(list(weights), x, g, activation, output_activation,
                                compute_dtype, input_soa, output_soa)
        return (dx, *[d.to(w.dtype) for d, w in zip(dws, weights)])

    @staticmethod
    def backward(ctx, ct_dx, *ct_dws):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "third derivatives of the fused MLP are not ported (ROADMAP.md Queue 1)")
        x, g, *weights = ctx.saved_tensors
        act, out_act, cdt, odt, soa_in, soa_out = ctx.args
        d_x, d_g, d_ws = fused_mlp_bwd_bwd_plain(weights, x, g, ct_dx, ct_dws, act,
                                                 out_act, cdt, odt, soa_in, soa_out)
        return (d_x, d_g.to(g.dtype) if d_g is not None else None,
                None, None, None, None, None, None, *d_ws)

"""Wrappers of kernels M and MB: fused-MLP forward (``csrc/fused_mlp.cu``)
and backward (``csrc/fused_mlp_bwd.cu``), and ``FusedMLPFunction`` and
``FusedMLPBackwardFunction``, which join them for autograd, second order
included.

M replaces ``tcnn_tpu/ops/pallas/fused_mlp.py::_fwd_kernel``, MB
``::_bwd_kernel``.  A CUDA tensor launches the kernel; a CPU tensor takes
``fused_mlp_plain`` / ``fused_mlp_bwd_plain``, the same functions in
plain PyTorch, which the CPU tests and ``chip_smoke.py`` hold the kernels
against.

M and MB hold all of a tile's layers in one CTA's shared memory.  Where a
chain does not fit (a wide input: past about 207 inputs at width 128 in
fp32 for M, 464 in bf16 for MB at three layers; or depth), the wrappers run
it in runs of consecutive layers (``plan_runs``): runs of M or MB where they
fit, and the first layer (or the last) alone where it does not, through
the instances of M and MB that stream one layer through shared memory in
chunks of its input features (``fused_mlp_wide_fwd``,
``fused_mlp_wide_bwd``; ``csrc/fused_mlp_wide.cu``), at any fan-in.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ...common import Activation
from .. import func_rules
from ..activations import activation_derivative, apply_activation
from . import kernels, require_cuda_tensors

SUPPORTED_WIDTHS = (16, 32, 64, 128)
MAX_LAYERS = 32   # layers of one launch of M or MB (csrc/mlp_common.cuh: kMaxLayers)
MAX_SMEM = 232448   # shared memory one CTA may use on sm_90
MAX_WIDE_COLUMNS = 128   # the streamed-layer instances' columns (fused_mlp_wide.cu: kMaxN)


def fused_mlp_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                    activation: Activation, output_activation: Activation,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    output_dtype: torch.dtype = torch.float32,
                    input_soa: bool = False,
                    output_soa: bool = False, graph_in_x: bool = True) -> torch.Tensor:
    """The bias-free chain y = out_act(act(act(x W_0) W_1 ...) W_out).

    Operands are rounded to ``compute_dtype``, each product is summed in
    fp32 (JAX's ``preferred_element_type=f32``: products of bf16 values
    are exact in fp32), the activation runs in fp32 and the result is
    rounded to ``compute_dtype`` between layers, as in _fwd_kernel.  On a
    CUDA device the caller disables TF32 where this is a reference.
    ``graph_in_x``: as ``apply_activation``'s.
    """
    h = (x.t() if input_soa else x).to(compute_dtype)
    for w in weights[:-1]:
        z = h.float() @ w.to(compute_dtype).float()
        h = apply_activation(z, activation, graph_in_x).to(compute_dtype)
    z = h.float() @ weights[-1].to(compute_dtype).float()
    y = apply_activation(z, output_activation, graph_in_x).to(output_dtype)
    return y.t() if output_soa else y


def _check_args(name: str, weights: Sequence[torch.Tensor], x: torch.Tensor,
                compute_dtype: torch.dtype, input_soa: bool) -> Tuple[int, int]:
    """What the kernels M and MB take; returns (D_in, D_out)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} is not supported")
    if len(weights) < 2:
        raise ValueError(f"{name}: needs 2 layers or more, got {len(weights)}")
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
    """The whole MLP in one kernel launch, or, beyond ``MAX_LAYERS``
    layers (the layer pointers one launch takes), in a chain of launches
    over runs of layers (``m_plan``): each inner run ends on the hidden
    activation, written in the compute dtype, which is what one launch
    holds between those layers, so a chain has one launch's bits.

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
    _check_args(name, weights, x, compute_dtype, input_soa)

    x = x.to(compute_dtype).contiguous()
    ws = [w.to(compute_dtype).contiguous() for w in weights]
    require_cuda_tensors(name, x, *ws)
    runs = m_plan(ws, compute_dtype, input_soa)
    if len(runs) == 1:
        return _fused_mlp_fwd_launch(ws, x, activation, output_activation, compute_dtype,
                                     output_dtype, input_soa, output_soa)
    return fused_mlp_fwd_chained(ws, x, activation, output_activation, compute_dtype,
                                 output_dtype, input_soa, output_soa, runs)


def m_plan(weights: Sequence[torch.Tensor], compute_dtype: torch.dtype,
           input_soa: bool) -> List[Tuple[int, int]]:
    """Kernel M's launches for these layers (``plan_runs``), from the shared
    memory one CTA of each run needs (the kernel's own layout): every
    shape that one launch takes keeps it."""
    return _m_plan(weights[0].shape[0], weights[0].shape[1], weights[-1].shape[1],
                   len(weights), compute_dtype == torch.bfloat16, input_soa)


@functools.lru_cache(maxsize=None)
def _m_plan(d_in: int, width: int, d_out: int, n_layers: int, bf16: bool,
            input_soa: bool) -> List[Tuple[int, int]]:
    def fits(a, b):
        return kernels().fused_mlp_fwd_smem_bytes(
            d_in if a == 0 else width, d_out if b == n_layers else width, width, b - a, bf16,
            input_soa and a == 0) <= MAX_SMEM

    return plan_runs(n_layers, fits)


def fused_mlp_fwd_chained(weights: Sequence[torch.Tensor], x: torch.Tensor,
                          activation: Activation, output_activation: Activation,
                          compute_dtype: torch.dtype, output_dtype: torch.dtype,
                          input_soa: bool, output_soa: bool,
                          runs: Sequence[Tuple[int, int]], fwd=None) -> torch.Tensor:
    """The MLP forward as one launch of M per run of layers (``m_plan``):
    each run but the last has ``activation`` as its output activation and
    the compute dtype as its output dtype, in ``_boundary_soa``'s layout,
    the next run's input.  ``fwd``: M's wrapper for one run (the CPU tests
    pass the plain version)."""
    fwd = fwd or _chain_fwd
    h, soa = x, input_soa
    for a, b in runs:
        last = b == len(weights)
        out_soa = output_soa if last else _boundary_soa(a, b, compute_dtype)
        h = fwd(list(weights[a:b]), h, activation, output_activation if last else activation,
                compute_dtype, output_dtype if last else compute_dtype, soa, out_soa)
        soa = out_soa
    return h


def _boundary_soa(a: int, b: int, compute_dtype: torch.dtype) -> bool:
    """The layout of run [a, b)'s output where the next run takes it: AoS
    (B, W), as one launch holds it, but feature-major after a streamed layer
    in fp32, the layout whose tiles M and MB copy by cp.async in fp32 (an
    AoS fp32 tile goes element by element)."""
    return b - a == 1 and compute_dtype == torch.float32


def _fused_mlp_fwd_launch(ws, x, activation, output_activation, compute_dtype, output_dtype,
                          input_soa, output_soa):
    """One launch of kernel M on x and weights already in the compute dtype,
    contiguous (``fused_mlp_fwd`` converts them)."""
    d_in, d_out = ws[0].shape[0], ws[-1].shape[1]
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


def _check_layer(name: str, w: torch.Tensor, x: torch.Tensor, compute_dtype: torch.dtype,
                 input_soa: bool) -> Tuple[int, int]:
    """What the streamed-layer instances take; returns (fan-in, fan-out)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {compute_dtype} is not supported")
    k, n = w.shape
    if not 1 <= n <= MAX_WIDE_COLUMNS:
        raise ValueError(f"{name}: {n} columns; the kernel takes 1 to {MAX_WIDE_COLUMNS}")
    if x.ndim != 2 or x.shape[0 if input_soa else 1] != k:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match the layer's "
                         f"fan-in {k} (input_soa={input_soa})")
    return k, n


def fused_mlp_wide_fwd(w: torch.Tensor, x: torch.Tensor, activation: Activation,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       output_dtype: torch.dtype = torch.float32, input_soa: bool = False,
                       output_soa: bool = False) -> torch.Tensor:
    """One layer y = act(x W) through kernel M's streamed-layer instance
    (``csrc/fused_mlp_wide.cu``): x and W pass through shared memory in
    chunks of input features, so any fan-in fits; W (K, N), N at most
    ``MAX_WIDE_COLUMNS``.  Operands in the compute dtype, sums in fp32,
    y in ``output_dtype``: ``fused_mlp_plain`` of one layer, which a CPU
    tensor takes."""
    if x.device.type == "cpu":
        return fused_mlp_plain([w], x, activation, activation, compute_dtype, output_dtype,
                               input_soa, output_soa)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_wide_fwd: unsupported device {x.device}")
    name = "fused_mlp_wide_fwd"
    if output_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: output dtype {output_dtype} is not supported")
    k, n = _check_layer(name, w, x, compute_dtype, input_soa)
    x = x.to(compute_dtype).contiguous()
    wc = w.to(compute_dtype).contiguous()
    require_cuda_tensors(name, x, wc)
    B = x.shape[1] if input_soa else x.shape[0]
    y = torch.empty((n, B) if output_soa else (B, n), dtype=output_dtype, device=x.device)
    if B == 0:
        return y
    xs_b, xs_d = (1, B) if input_soa else (k, 1)
    ys_b, ys_d = (1, B) if output_soa else (n, 1)
    kernels().fused_mlp_wide_fwd(x, xs_b, xs_d, wc, y, ys_b, ys_d, B,
                                 list(Activation).index(activation))
    fused_mlp_wide_fwd.launches += 1
    return y


fused_mlp_wide_fwd.launches = 0


def fused_mlp_bwd_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                        g: torch.Tensor, activation: Activation,
                        output_activation: Activation,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        input_soa: bool = False, output_soa: bool = False,
                        dx_dtype: Optional[torch.dtype] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of kernel MB, step for step as _bwd_kernel
    (fused_mlp.py:113-198 of the JAX package): the forward recomputed with
    the rounding of ``fused_mlp_plain``; dz = g · out_act'(z_out) rounded
    to ``compute_dtype``; per layer, from the last, dW = hᵀ dz and
    dh = dz Wᵀ in fp32, then dz = dh · act'(z) rounded.  Returns the
    weight gradients in fp32 and dx in x's layout and dtype (or
    ``dx_dtype``).  It is not autograd of ``fused_mlp_plain``, which would
    round elsewhere."""
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
    dx = (dh.t() if input_soa else dh).to(dx_dtype or x.dtype)
    return dws, dx


def plan_runs(n_layers: int, fits) -> List[Tuple[int, int]]:
    """Runs of consecutive layers, one launch of M or MB each, for a chain
    of ``n_layers`` layers: ``mb_segments``' runs of at most ``MAX_LAYERS``
    where it finds some that ``fits(first, end)`` (``lambda a, b: True``
    plans by depth alone), so that every shape the fused kernels take keeps
    its launches; else the first layer, the last one or both alone (a run
    of one layer: the streamed-layer instances, which take any fan-in) and
    the layers between in ``mb_segments``' runs, or alone where one is
    left.  Raises where none of these fit."""
    def fits_one(a, b):   # one launch: at most MAX_LAYERS layers that fit
        return b - a <= MAX_LAYERS and fits(a, b)

    try:
        return mb_segments(n_layers, fits_one)
    except NotImplementedError:
        pass
    L = n_layers
    for head, tail in ((1, 0), (0, 1), (1, 1)):
        a, b = head, L - tail
        if b - a < 2:
            mid = [(a, b)] if b - a == 1 else []
        else:
            try:
                mid = [(a + s, a + e)
                       for s, e in mb_segments(b - a, lambda s, e: fits_one(a + s, a + e))]
            except NotImplementedError:
                continue
        return [(0, 1)] * head + mid + [(L - 1, L)] * tail
    raise NotImplementedError(
        f"no runs of {n_layers} layers fit, with the first or last layer alone or not")


def mb_segments(n_layers: int, fits) -> List[Tuple[int, int]]:
    """Kernel MB's launches for a chain of ``n_layers`` layers: the whole
    chain, where one launch takes it (``fits(0, n_layers)``), else the
    fewest runs of consecutive layers, as even as may be and each of at
    least two, that each fit (``fits(first, end)``).  Raises where none do."""
    for k in range(1, n_layers // 2 + 1):
        sizes = [n_layers // k + (i < n_layers % k) for i in range(k)]
        ends = [sum(sizes[:i + 1]) for i in range(k)]
        segs = list(zip([0] + ends[:-1], ends))
        if all(fits(a, b) for a, b in segs):
            return segs
    raise NotImplementedError(
        f"kernel MB fits no split of {n_layers} layers into runs of two or more")


def fused_mlp_bwd_segmented(weights: Sequence[torch.Tensor], x: torch.Tensor,
                            g: torch.Tensor, activation: Activation,
                            output_activation: Activation, compute_dtype: torch.dtype,
                            input_soa: bool, output_soa: bool,
                            segments: Sequence[Tuple[int, int]], fwd=None, bwd=None
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The MLP backward as one launch of MB per run of layers (``mb_plan``,
    ``plan_runs``), for chains whose hidden activations or first layer of
    one tile do not fit in an SM's shared memory: the activations at the
    runs' boundaries are kept in device memory, as the CUDA original's
    backward reads the forward's stored activations.  Kernel M computes
    them, h_a = act(z_{a-1}) rounded to the compute dtype over layers
    [0, a) run by run (M with ``activation`` as its output activation and
    the compute dtype as its output dtype: the bits the fused chain holds;
    a run of one layer through M's streamed-layer instance).  Then MB runs
    each run from the last (a run of one layer through MB's streamed-layer
    instance): the run's input is h_a, its output gradient the next run's
    dx in fp32, and its output activation ``activation``
    (``output_activation`` for the last run), so that its first step,
    dz = g · act'(z) rounded, is the fused chain's own step at that layer.
    ``fwd``/``bwd``: the forward and backward of a run (the CPU tests pass
    the plain versions)."""
    fwd = fwd or _chain_fwd
    bwd = bwd or _bwd_run
    L = len(weights)
    inputs = {0: (x, input_soa)}
    h, soa = x, input_soa
    for a, b in segments[:-1]:
        out_soa = _boundary_soa(a, b, compute_dtype)
        h = fwd(list(weights[a:b]), h, activation, activation, compute_dtype, compute_dtype,
                soa, out_soa)
        soa = out_soa
        inputs[b] = (h, soa)
    dws: List[Optional[torch.Tensor]] = [None] * L
    gseg, gsoa = g, output_soa
    for a, b in reversed(segments):
        xin, xsoa = inputs[a]
        seg_dws, gseg = bwd(list(weights[a:b]), xin, gseg, activation,
                            output_activation if b == L else activation, compute_dtype, xsoa,
                            gsoa, dx_dtype=x.dtype if a == 0 else torch.float32)
        dws[a:b] = seg_dws
        gsoa = xsoa   # dx has the run's input's layout
    return dws, gseg


def _chain_fwd(ws, x, activation, output_activation, compute_dtype, output_dtype, input_soa,
               output_soa):
    """The forward of a run of layers: M's streamed-layer instance for one
    layer (``output_activation`` is its activation), else ``fused_mlp_fwd``
    (one launch of M for a run that ``m_plan`` planned)."""
    if len(ws) == 1:
        return fused_mlp_wide_fwd(ws[0], x, output_activation, compute_dtype, output_dtype,
                                  input_soa, output_soa)
    return fused_mlp_fwd(ws, x, activation, output_activation, compute_dtype, output_dtype,
                         input_soa, output_soa)


def _bwd_run(weights, x, g, activation, output_activation, compute_dtype, input_soa,
             output_soa, dx_dtype):
    """The backward of one run of layers: MB's streamed-layer instance for
    one layer (``output_activation`` is its activation), else one launch of
    MB (the plain version for a CPU tensor)."""
    if len(weights) == 1:
        dw, dx = fused_mlp_wide_bwd(weights[0], x, g, output_activation, compute_dtype,
                                    input_soa, output_soa, dx_dtype)
        return [dw], dx
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(weights, x, g, activation, output_activation, compute_dtype,
                                   input_soa, output_soa, dx_dtype)
    return _fused_mlp_bwd_launch(weights, x, g, activation, output_activation, compute_dtype,
                                 input_soa, output_soa, dx_dtype)


def fused_mlp_wide_bwd(w: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                       activation: Activation, compute_dtype: torch.dtype = torch.bfloat16,
                       input_soa: bool = False, output_soa: bool = False,
                       dx_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of one layer y = act(x W) through kernel MB's
    streamed-layer instance (``csrc/fused_mlp_wide.cu``), MB's step at a
    layer: dz = g · act'(z) rounded to the compute dtype, dW = xᵀ dz and
    dx = dz Wᵀ in fp32, x and W streamed through shared memory in chunks of
    input features.  Returns (dW float32, dx in x's layout and dtype, or
    ``dx_dtype``): ``fused_mlp_bwd_plain`` of one layer, which a CPU tensor
    takes.  dW is deterministic (per-CTA partials summed in CTA order)."""
    if x.device.type == "cpu":
        dws, dx = fused_mlp_bwd_plain([w], x, g, activation, activation, compute_dtype,
                                      input_soa, output_soa, dx_dtype)
        return dws[0], dx
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_wide_bwd: unsupported device {x.device}")
    name = "fused_mlp_wide_bwd"
    dx_dtype = dx_dtype or x.dtype
    if dx_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dx dtype {dx_dtype} is not supported")
    k, n = _check_layer(name, w, x, compute_dtype, input_soa)
    B = x.shape[1] if input_soa else x.shape[0]
    if g.shape != ((n, B) if output_soa else (B, n)):
        raise ValueError(f"{name}: output gradient {tuple(g.shape)} does not match "
                         f"B={B}, N={n} (output_soa={output_soa})")
    xc = x.to(compute_dtype).contiguous()
    wc = w.to(compute_dtype).contiguous()
    gf = g.float()
    require_cuda_tensors(name, xc, wc, gf)
    dw = torch.zeros((k, n), dtype=torch.float32, device=x.device)
    dx = torch.empty((k, B) if input_soa else (B, k), dtype=dx_dtype, device=x.device)
    if B == 0:
        return dw, dx
    xs_b, xs_d = (1, B) if input_soa else (k, 1)
    gs_b, gs_d = (gf.stride(1), gf.stride(0)) if output_soa else gf.stride()
    kernels().fused_mlp_wide_bwd(xc, xs_b, xs_d, wc, gf, gs_b, gs_d, dx, xs_b, xs_d, dw, B,
                                 list(Activation).index(activation))
    fused_mlp_wide_bwd.launches += 1
    return dw, dx


fused_mlp_wide_bwd.launches = 0


def _fused_mlp_bwd_launch(weights, x, g, activation, output_activation, compute_dtype,
                          input_soa, output_soa, dx_dtype):
    """One launch of kernel MB; dx in ``dx_dtype``."""
    d_in, d_out = weights[0].shape[0], weights[-1].shape[1]
    B = x.shape[1] if input_soa else x.shape[0]
    acts = list(Activation)
    xc = x.to(compute_dtype).contiguous()
    ws = [w.to(compute_dtype).contiguous() for w in weights]
    gf = g.float()
    require_cuda_tensors("fused_mlp_bwd", xc, gf, *ws)
    sizes = [w.numel() for w in weights]
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty((d_in, B) if input_soa else (B, d_in), dtype=dx_dtype, device=x.device)
    xs_b, xs_d = (1, B) if input_soa else (d_in, 1)
    gs_b, gs_d = (gf.stride(1), gf.stride(0)) if output_soa else gf.stride()
    kernels().fused_mlp_bwd(xc, xs_b, xs_d, ws, gf, gs_b, gs_d, dx, xs_b, xs_d, dw, B,
                            acts.index(activation), acts.index(output_activation), input_soa)
    fused_mlp_bwd.launches += 1
    return [d.view(w.shape) for d, w in zip(dw.split(sizes), weights)], dx


def fused_mlp_bwd(weights: Sequence[torch.Tensor], x: torch.Tensor,
                  g: torch.Tensor, activation: Activation,
                  output_activation: Activation,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  input_soa: bool = False, output_soa: bool = False
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The whole MLP backward in one kernel launch (and a small reduction).

    weights, x, layouts: as for ``fused_mlp_fwd``.  g: the output gradient,
    (B, D_out), or (D_out, B) with ``output_soa``, any strides.  Returns
    ([dW per layer] float32, dx in x's dtype and layout).  Where one CTA's
    share of the hidden activations exceeds an SM's shared memory (width
    128 beyond about 10 hidden layers in bf16, 8 in fp32), or the first
    layer's weights and input tile do (past about 464 inputs at width 128
    in bf16, 288 in fp32, three layers), the backward runs as a few
    launches over runs of layers (``mb_plan``), MB for runs of two layers
    or more and its streamed-layer instance for the first (or last) layer
    alone, with kernel M computing the activations at their boundaries
    (``fused_mlp_bwd_segmented``); every shape one launch takes keeps it.
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
    if B == 0:
        return ([torch.zeros(w.shape, dtype=torch.float32, device=x.device) for w in weights],
                torch.empty((d_in, 0) if input_soa else (0, d_in), dtype=x.dtype,
                            device=x.device))
    segments = mb_plan(weights, compute_dtype, activation, output_activation)
    if len(segments) == 1:
        return _fused_mlp_bwd_launch(weights, x, g, activation, output_activation,
                                     compute_dtype, input_soa, output_soa, x.dtype)
    return fused_mlp_bwd_segmented(weights, x, g, activation, output_activation,
                                   compute_dtype, input_soa, output_soa, segments)


def mb_plan(weights: Sequence[torch.Tensor], compute_dtype: torch.dtype,
            activation: Activation, output_activation: Activation) -> List[Tuple[int, int]]:
    """Kernel MB's launches for these layers (``plan_runs``), from the
    shared memory one CTA of each run needs (the kernel's own layout)."""
    acts = list(Activation)
    return _mb_plan(weights[0].shape[0], weights[0].shape[1], weights[-1].shape[1],
                    len(weights), compute_dtype == torch.bfloat16, acts.index(activation),
                    acts.index(output_activation))


@functools.lru_cache(maxsize=None)
def _mb_plan(d_in: int, width: int, d_out: int, L: int, bf16: bool, act: int,
             out_act: int) -> List[Tuple[int, int]]:
    def fits(a, b):
        return kernels().fused_mlp_bwd_smem_bytes(
            d_in if a == 0 else width, d_out if b == L else width, width, b - a, bf16, act,
            out_act if b == L else act) <= MAX_SMEM

    return plan_runs(L, fits)


fused_mlp_bwd.launches = 0


def fused_mlp_bwd_bwd_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                            g: torch.Tensor, ct_dx: Optional[torch.Tensor],
                            ct_dws: Sequence[Optional[torch.Tensor]],
                            activation: Activation, output_activation: Activation,
                            compute_dtype: torch.dtype, output_dtype: torch.dtype,
                            input_soa: bool = False, output_soa: bool = False,
                            create_graph: bool = False):
    """The backward of the MLP backward: given the cotangents of its
    outputs (dx and each dW; None for none), the gradients of
    ⟨(dx, dW), (ct_dx, ct_dW)⟩ in x, g and the weights.  Autograd of the
    autograd of ``fused_mlp_plain``, as the JAX package derives
    ``_fused_mlp_bwd_op``'s VJP from ``_jnp_mlp_ref``
    (``tcnn_tpu/ops/pallas/fused_mlp.py:334-347``): products by
    ``torch.matmul`` outside any kernel.  ReLU's derivative is taken as a
    constant mask (``graph_in_x=False``), so the zero second derivative
    builds no products of zeros.  Returns (d_x, d_g, [d_W]), None where a
    gradient is zero by construction.

    ``create_graph``: the result keeps its graph in x, g, the weights and
    the cotangents (the tensors that require a gradient are used as they
    are, not detached), so that a third derivative differentiates it, as
    JAX's autodiff of the XLA chain goes to any order
    (``tcnn_tpu/models/networks/fused_mlp.py:97-121``).  Inside a
    ``torch.func`` transform (``jacfwd`` of a second derivative) the same
    products come from ``torch.func.vjp``, which composes with the
    transform where ``torch.autograd.grad`` may not."""
    if torch._C._are_functorch_transforms_active():
        def first(xx, gg, *ws):
            _, pull = torch.func.vjp(
                lambda x_, *w_: fused_mlp_plain(w_, x_, activation, output_activation,
                                                compute_dtype, output_dtype, input_soa,
                                                output_soa, graph_in_x=False), xx, *ws)
            return pull(gg.to(output_dtype))

        outs, pull2 = torch.func.vjp(first, x, g, *weights)
        d_x, d_g, *d_ws = pull2(tuple(torch.zeros_like(o) if c is None else c.to(o.dtype)
                                      for o, c in zip(outs, (ct_dx, *ct_dws))))
        return d_x, d_g, d_ws

    def leaf(t):   # differentiable in t: t itself where it carries a graph
        return t if create_graph and t.requires_grad else t.detach().requires_grad_()

    with torch.enable_grad():
        xx, gg = leaf(x), leaf(g)
        ws = [leaf(w) for w in weights]
        y = fused_mlp_plain(ws, xx, activation, output_activation, compute_dtype,
                            output_dtype, input_soa, output_soa, graph_in_x=False)
        first = torch.autograd.grad(y, [xx, *ws], grad_outputs=gg.to(y.dtype),
                                    create_graph=True)
        pairs = [(f, c.to(f.dtype)) for f, c in zip(first, (ct_dx, *ct_dws))
                 if c is not None and f.requires_grad]
        if not pairs:
            return None, None, [None] * len(ws)
        d_x, d_g, *d_ws = torch.autograd.grad(
            [f for f, _ in pairs], [xx, gg, *ws], grad_outputs=[c for _, c in pairs],
            allow_unused=True, create_graph=create_graph)
    return d_x, d_g, d_ws


def fused_mlp_tangent_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                            t_x: Optional[torch.Tensor],
                            t_ws: Sequence[Optional[torch.Tensor]], activation: Activation,
                            output_activation: Activation, compute_dtype: torch.dtype,
                            output_dtype: torch.dtype, input_soa: bool = False,
                            output_soa: bool = False) -> torch.Tensor:
    """The tangent of ``fused_mlp_plain`` at (x, W) along (t_x, t_W) (None:
    zero), forward mode written out: t_z = t_h W + h t_W in fp32, t_h' =
    act'(z)·t_z, each tangent rounded where its primal is (JAX's jvp of
    ``astype`` rounds the tangent too), as ``jax.jvp`` of the JAX package's
    XLA chain gives it (``tcnn_tpu/models/networks/fused_mlp.py:112-119``,
    its fallback under a forward-mode trace).  Plain torch operations, so
    ``torch.func.vmap`` runs it on batched tangents."""
    cdt = compute_dtype
    h = (x.t() if input_soa else x).to(cdt)
    t = None if t_x is None else (t_x.t() if input_soa else t_x).to(cdt)
    last = len(weights) - 1
    for i, w in enumerate(weights):
        wc = w.to(cdt).float()
        z = h.float() @ wc
        tz = None if t is None else t.float() @ wc
        if t_ws[i] is not None:
            tw = h.float() @ t_ws[i].to(cdt).float()
            tz = tw if tz is None else tz + tw
        act = output_activation if i == last else activation
        if tz is not None:
            t = (tz * activation_derivative(z, act)).to(output_dtype if i == last else cdt)
        if i < last:
            h = apply_activation(z, act).to(cdt)
    if t is None:
        t = torch.zeros((h.shape[0], weights[-1].shape[1]), dtype=output_dtype, device=x.device)
    return t.t() if output_soa else t


class FusedMLPFunction(torch.autograd.Function):
    """The fused MLP with its explicit backward, the counterpart of
    ``_fused_mlp``'s custom VJP (``tcnn_tpu/ops/pallas/fused_mlp.py:228-233,
    :276-284, :353-357``).  It saves the input and the fp32 master weights
    and the backward recomputes the activations, as _bwd_kernel does.  The
    weight gradients come back in fp32, the masters' dtype; dx in x's
    dtype, computed in fp32 and cast once (:416-420).  Under
    ``create_graph`` the backward is ``FusedMLPBackwardFunction``, so it
    can be differentiated once more.

    ``torch.func`` (the transform picks the route, never a failed launch):
    ``jvp`` is ``fused_mlp_tangent_plain``, plain torch math, as the JAX
    package computes the tangent in its XLA chain outside the Pallas
    kernel (``tcnn_tpu/models/networks/fused_mlp.py:112-119``); the primal
    stays kernel M's.  ``vmap`` (``func_rules``): a vmapped x folds into
    the batch, one launch; vmapped weights take a launch per entry."""

    @staticmethod
    def forward(x, activation, output_activation, compute_dtype, output_dtype, input_soa,
                output_soa, *weights):
        return fused_mlp_fwd(list(weights), x, activation, output_activation, compute_dtype,
                             output_dtype, input_soa, output_soa)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, *args = inputs[:7]
        ctx.set_materialize_grads(False)   # no gradient in, no kernel launched
        ctx.args = tuple(args)
        ctx.save_for_backward(x, *inputs[7:])
        ctx.save_for_forward(x, *inputs[7:])

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

    @staticmethod
    def jvp(ctx, t_x, *tangents):
        x, *weights = ctx.saved_tensors
        return fused_mlp_tangent_plain(weights, x, t_x, tangents[6:], *ctx.args)

    @staticmethod
    def vmap(info, in_dims, x, *rest):
        args = (x, *rest)
        if any(d is not None for d in in_dims[7:]):
            return func_rules.loop(FusedMLPFunction, info, in_dims, args)
        n, soa_in, soa_out = info.batch_size, rest[4], rest[5]
        y = FusedMLPFunction.apply(func_rules.fold(x, in_dims[0], n, 1 if soa_in else 0), *rest)
        return func_rules.unfold(y, n, 1 if soa_out else 0), 1 if soa_out else 0


class FusedMLPBackwardFunction(torch.autograd.Function):
    """The MLP backward ``(x, g, W) → (dx, dW)`` as a differentiable
    function, the counterpart of ``_fused_mlp_bwd_op``
    (``tcnn_tpu/ops/pallas/fused_mlp.py:307-350``).  Forward: kernel MB.
    Backward: ``fused_mlp_bwd_bwd_plain``, autograd of autograd of the
    plain chain, which recomputes the activations: like
    ``FusedMLPFunction`` it saves only x, g and the weights (x is the
    forward's own tensor, not a second copy).  Where x's gradient is zero
    by construction (a ReLU MLP's dx does not depend on x) it is returned
    as zeros, as JAX's VJP gives them, except into a grid encoding's
    backward, which would launch kernels GB and GI to add nothing.  Under
    ``create_graph`` the backward keeps its graph
    (``fused_mlp_bwd_bwd_plain(create_graph=True)``, torch operations), so
    a third derivative differentiates it.

    ``torch.func``: ``jvp`` along (t_x, t_g, t_W) is MB on t_g (the
    backward is linear in g: a kernel) plus the gradient in (x, W) of
    ⟨g, J·(t_x, t_W)⟩, J·t from ``fused_mlp_tangent_plain`` and its
    gradient by ``torch.func.vjp``, plain torch math as JAX forms it in XLA.
    ``vmap``: a launch per entry.  dx alone would fold a vmapped x or g into
    the batch, but MB's dW sums over the samples, and the function returns
    it: a fold would mix the entries' dW."""

    @staticmethod
    def forward(x, g, activation, output_activation, compute_dtype, output_dtype, input_soa,
                output_soa, *weights):
        dws, dx = fused_mlp_bwd(list(weights), x, g, activation, output_activation,
                                compute_dtype, input_soa, output_soa)
        return (dx, *[d.to(w.dtype) for d, w in zip(dws, weights)])

    @staticmethod
    def setup_context(ctx, inputs, output):
        from ..grid_ops import GridEncodeFunction

        x, g, *args = inputs[:8]
        ctx.set_materialize_grads(False)
        ctx.args = tuple(args)
        ctx.x_from_grid = isinstance(x.grad_fn, GridEncodeFunction._backward_cls)
        ctx.save_for_backward(x, g, *inputs[8:])
        ctx.save_for_forward(x, g, *inputs[8:])

    @staticmethod
    def backward(ctx, ct_dx, *ct_dws):
        x, g, *weights = ctx.saved_tensors
        act, out_act, cdt, odt, soa_in, soa_out = ctx.args
        d_x, d_g, d_ws = fused_mlp_bwd_bwd_plain(weights, x, g, ct_dx, ct_dws, act,
                                                 out_act, cdt, odt, soa_in, soa_out,
                                                 create_graph=torch.is_grad_enabled())
        if d_x is None and ctx.needs_input_grad[0] and not ctx.x_from_grid:
            d_x = torch.zeros_like(x)
        return (d_x, d_g.to(g.dtype) if d_g is not None else None,
                None, None, None, None, None, None, *d_ws)

    @staticmethod
    def jvp(ctx, t_x, t_g, *tangents):
        x, g, *weights = ctx.saved_tensors
        act, out_act, cdt, odt, soa_in, soa_out = ctx.args
        t_ws = tangents[6:]
        t_dx = t_dws = None
        if t_g is not None:
            t_dx, *t_dws = FusedMLPBackwardFunction.apply(x, t_g, *ctx.args, *weights)
        if t_x is not None or any(t is not None for t in t_ws):
            def inner(xx, *ws):
                return fused_mlp_tangent_plain(ws, xx, t_x, t_ws, act, out_act, cdt, odt,
                                               soa_in, soa_out)

            _, pullback = torch.func.vjp(inner, x, *weights)
            h_x, *h_ws = pullback(g.to(odt))
            t_dx = h_x if t_dx is None else t_dx + h_x
            t_dws = h_ws if t_dws is None else [a + b for a, b in zip(t_dws, h_ws)]
        return (t_dx.to(x.dtype), *[t.to(w.dtype) for t, w in zip(t_dws, weights)])

    @staticmethod
    def vmap(info, in_dims, *args):
        return func_rules.loop(FusedMLPBackwardFunction, info, in_dims, args)

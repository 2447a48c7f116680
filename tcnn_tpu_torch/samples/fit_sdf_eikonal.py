"""SDF fitting with eikonal regularization, the port's counterpart of
``samples/fit_sdf_eikonal.py`` (the double-backward demo).

    python -m tcnn_tpu_torch.samples.fit_sdf_eikonal [n_steps] [batch_pow]

A HashGrid + FullyFusedMLP is fitted to the signed distance field of a
sphere with the loss

    L = |f(x_surf)|^2  +  0.1 · (|∇x f(x_vol)| − 1)^2

whose gradient in the parameters flows through ∇x f: the grid's and the
MLP's second derivatives (kernels GI and GG, and MB's differentiable
backward).  Smoothstep interpolation makes ∇x f continuous.  The model is
built by ``create_from_config`` at the fp32 policy and trained through
``model.network`` and ``model.optimizer``, as the JAX sample does.  The
JAX sample jits its step; here, on the card, the first step runs eagerly
(the warm-up that capture needs) and every later step replays one CUDA
graph of the step, into whose static buffers each step's points are
copied; on the CPU every step runs eagerly.  Surface and volume samples
come from a ``torch.Generator`` seeded with 1 on the device, drawn outside
the graph, the evaluation points from one seeded with 7; PyTorch draws other numbers than ``jax.random``,
so the run follows the JAX sample in distribution, not sample by sample.
"""

from __future__ import annotations

import functools
import sys
import time
from typing import Tuple

import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.trainer import _capture_step

CONFIG = {
    "loss": {"otype": "L2"},              # unused: custom loss below
    "optimizer": {"otype": "Adam", "learning_rate": 1e-3},
    "encoding": {"otype": "HashGrid", "n_levels": 8,
                 "n_features_per_level": 2, "log2_hashmap_size": 15,
                 "base_resolution": 4, "per_level_scale": 1.5,
                 "interpolation": "Smoothstep"},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64,
                "n_hidden_layers": 2, "activation": "ReLU",
                "output_activation": "None"},
}

CENTER = (0.5, 0.5, 0.5)
RADIUS = 0.3
EIKONAL_WEIGHT = 0.1
EVAL_SAMPLES = 1 << 14


def true_sdf(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x - x.new_tensor(CENTER), dim=-1) - RADIUS


def sample_points(gen: torch.Generator, batch: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_surf, x_vol): random directions scaled onto the sphere, and
    uniform points in [0.05, 0.95]^3."""
    d = torch.randn((batch, 3), generator=gen, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    x_surf = d.new_tensor(CENTER) + RADIUS * d
    x_vol = torch.rand((batch, 3), generator=gen, device=device) * 0.9 + 0.05
    return x_surf, x_vol


def eikonal_loss(grad_x: torch.Tensor) -> torch.Tensor:
    grad_norm = torch.sqrt(torch.sum(grad_x * grad_x, dim=-1) + 1e-12)
    return torch.mean((grad_norm - 1.0) ** 2)


def loss_fn(net, x_surf: torch.Tensor, x_vol: torch.Tensor):
    """(loss, surface loss, eikonal loss) of ``net`` on the samples, with
    the graph kept for a gradient in the parameters."""
    surf_loss = torch.mean(net(x_surf)[:, 0] ** 2)
    # Per-sample input gradients in one reverse pass: f is sample-wise, so
    # the rows of ∇x Σ_b f(x_b) are the per-sample ∇x f.
    x_vol = x_vol.detach().requires_grad_()
    (grad_x,) = torch.autograd.grad(net(x_vol)[:, 0].sum(), x_vol, create_graph=True)
    eik_loss = eikonal_loss(grad_x)
    return surf_loss + EIKONAL_WEIGHT * eik_loss, surf_loss, eik_loss


def loss_and_grads(net, x_surf: torch.Tensor, x_vol: torch.Tensor, aux: bool = False):
    """The loss (with ``aux``: and the surface and eikonal terms) and its
    gradients by parameter name; nothing is updated."""
    params = dict(net.named_parameters())
    losses = loss_fn(net, x_surf, x_vol)
    grads = torch.autograd.grad(losses[0], list(params.values()))
    losses = tuple(t.detach() for t in losses)
    return (losses if aux else losses[0]), dict(zip(params, grads))


# The curvature term's weight λ in L + λ · mean |H v|² (``curvature_loss``).
CURVATURE_WEIGHT = 1e-3


def sample_directions(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """(B, 3) random unit directions, one per point."""
    v = torch.randn((batch, 3), generator=gen, device=device)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def curvature_loss(f, x_surf: torch.Tensor, x_vol: torch.Tensor, v: torch.Tensor,
                   weight: float = CURVATURE_WEIGHT) -> torch.Tensor:
    """The eikonal loss plus a curvature regulariser, ``weight`` · mean
    |H v|², H the Hessian of f in x at x_vol and v (B, 3) a direction per
    point (as neural SDF fits penalise curvature): f(x)[:, 0] is the SDF.
    H v is the gradient of ⟨∇x f, v⟩ in x, a second reverse pass, so the
    loss's gradient in the parameters is a third derivative: kernel GT and
    the MLP's third order on the card.  The graph is kept."""
    surf_loss = torch.mean(f(x_surf)[:, 0] ** 2)
    x_vol = x_vol.detach().requires_grad_()
    (grad_x,) = torch.autograd.grad(f(x_vol)[:, 0].sum(), x_vol, create_graph=True)
    (hv,) = torch.autograd.grad((grad_x * v).sum(), x_vol, create_graph=True)
    return (surf_loss + EIKONAL_WEIGHT * eikonal_loss(grad_x)
            + weight * torch.mean(torch.sum(hv * hv, dim=-1)))


def curvature_loss_and_grads(net, x_surf: torch.Tensor, x_vol: torch.Tensor, v: torch.Tensor):
    """``curvature_loss`` of ``net`` and its gradients by parameter name."""
    params = dict(net.named_parameters())
    loss = curvature_loss(net, x_surf, x_vol, v)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def step(net, opt, opt_state, x_surf: torch.Tensor, x_vol: torch.Tensor):
    """One training step of ``net`` by ``opt`` (the JAX sample's ``step``),
    updating the parameters and ``opt_state`` in place.  Returns (loss,
    surface, eikonal) as device scalars."""
    loss, grads = loss_and_grads(net, x_surf, x_vol, aux=True)
    opt.step(opt_state, grads, dict(net.named_parameters()))
    return loss


def mean_sdf_error(net, device, n: int = EVAL_SAMPLES, seed: int = 7) -> float:
    """Mean |f(x) − sdf(x)| over n uniform points in [0.2, 0.8]^3."""
    gen = torch.Generator(device).manual_seed(seed)
    xs = torch.rand((n, 3), generator=gen, device=device) * 0.6 + 0.2
    with torch.inference_mode():
        return float(torch.mean(torch.abs(net(xs)[:, 0] - true_sdf(xs))))


def main(argv, device=None, config=None) -> dict:
    """The fit; ``config``: the model's config in place of ``CONFIG``."""
    n_steps = int(argv[1]) if len(argv) > 1 else 500
    batch = 1 << (int(argv[2]) if len(argv) > 2 else 14)

    model = tcnn.create_from_config(3, 1, config or CONFIG, policy=tcnn.Policy(),
                                    device=device)
    net, opt = model.network, model.optimizer
    opt_state = opt.init(dict(net.named_parameters()), net.param_layout())
    device = next(net.parameters()).device
    gen = torch.Generator(device).manual_seed(1)

    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = None
    for i in range(n_steps):
        points = sample_points(gen, batch, device)
        if device.type != "cuda":
            loss, sl, el = step(net, opt, opt_state, *points)
        elif captured is None:
            captured, (loss, sl, el) = _capture_step(
                functools.partial(step, net, opt, opt_state), points)
        else:
            loss, sl, el = captured(*points)
        losses.append(loss)
        if i % 50 == 0 or i == n_steps - 1:
            print(f"step {i}: loss={float(loss):.6f} "
                  f"surface={float(sl):.6f} eikonal={float(el):.6f}", flush=True)
    losses = torch.stack(losses).cpu()
    dt = time.perf_counter() - t0
    print(f"{n_steps} steps in {dt:.1f}s")

    err = mean_sdf_error(net, device)
    print(f"mean |sdf error| on volume samples: {err:.4f}")
    return {"losses": losses, "sdf_error": err, "seconds": dt}


if __name__ == "__main__":
    main(sys.argv)

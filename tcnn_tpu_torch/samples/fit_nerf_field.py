"""NeRF-style radiance field, the instant-ngp model split: the port's
counterpart of ``samples/fit_nerf_field.py``.

    python -m tcnn_tpu_torch.samples.fit_nerf_field [n_steps] [batch_pow] [out.jpg]

    density net : HashGrid(3-D position) → FullyFusedMLP → [σ_raw | 15 features]
    colour net  : Composite[Identity(features), SphericalHarmonics(view dir)]
                  → FullyFusedMLP → RGB (Sigmoid)

trained by volume-rendering random rays through a synthetic emissive
scene (three coloured Gaussian blobs) and regressing the composited colour
against an analytic render, with instant-ngp's coarse-to-fine schedule:
the grid's per-sample ``max_level`` (grid.h:69-92), a device tensor on
every step, unlocks the levels linearly over the first quarter of the run
(at most 100 steps).  Both nets are built by
``create_network_with_input_encoding`` and trained by ``create_optimizer``'s
Adam through autograd.  The JAX sample jits its step; here, on the card (the
default), the first step runs eagerly (the warm-up that capture needs) and
every later step replays one CUDA graph of the step, which reads the rays,
the jitter and the per-sample level fractions from static buffers filled
before each replay: one graph serves the coarse-to-fine ramp and the steps
after it.  The policy there is ``BF16_POLICY``, as the JAX sample chooses on
its accelerator, and each step runs kernels G, M (twice), MB (twice) and GB;
``device="cpu"`` runs every step eagerly through the plain versions at the
fp32 policy.  Rays and the stratified jitter come from a
``torch.Generator`` seeded with 42 on the device, drawn outside the graph,
the parameters from a CPU generator seeded with 0: PyTorch draws
other numbers than ``jax.random``, so a run follows the JAX sample in
distribution, not ray by ray.

The JAX sample at its defaults (400 steps of 2^12 rays × 48 samples, 128²
evaluation render) on the CPU, fp32: eval PSNR 36.89 dB (mse 0.000205).
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import Dict, Optional, Tuple, Union

import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.common import resolve_device
from tcnn_tpu_torch.trainer import _capture_step
from tcnn_tpu_torch.utils.image import mse2psnr, write_image

# ---------------------------------------------------------------- scene
# Emission-absorption volume in [0,1]^3: three Gaussian density blobs,
# each with its own emission colour.
BLOB_CENTERS = [[0.35, 0.40, 0.45], [0.62, 0.55, 0.50], [0.50, 0.68, 0.42]]
BLOB_SIGMA = [0.07, 0.09, 0.06]
BLOB_DENSITY = [28.0, 22.0, 30.0]
BLOB_COLOR = [[0.9, 0.25, 0.15], [0.15, 0.7, 0.95], [0.95, 0.85, 0.2]]
BACKGROUND = [0.03, 0.03, 0.05]


@functools.lru_cache(maxsize=None)
def _scene(device: torch.device) -> Dict[str, torch.Tensor]:
    """The scene's constants on ``device``, copied there once."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in (("centers", BLOB_CENTERS), ("sigma", BLOB_SIGMA),
                         ("density", BLOB_DENSITY), ("color", BLOB_COLOR),
                         ("background", BACKGROUND))}


def true_field(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic (σ, rgb) of the synthetic scene at points x (B, 3)."""
    s = _scene(x.device)
    d2 = torch.sum((x[:, None, :] - s["centers"][None]) ** 2, dim=-1)
    w = s["density"] * torch.exp(-0.5 * d2 / s["sigma"] ** 2)       # (B, 3 blobs)
    sigma = torch.sum(w, dim=-1)
    rgb = (w @ s["color"]) / (sigma[:, None] + 1e-8)
    return sigma, rgb


# --------------------------------------------------------------- model

N_FEATURES = 16          # density head: 1 raw σ + 15 geometry features
SH_DEGREE = 4            # 16 view-direction basis functions

DENSITY_CFG = {
    "encoding": {"otype": "HashGrid", "n_levels": 12,
                 "n_features_per_level": 2, "log2_hashmap_size": 17,
                 "base_resolution": 16, "per_level_scale": 1.45},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64,
                "n_hidden_layers": 1, "activation": "ReLU",
                "output_activation": "None"},
}
COLOR_CFG = {
    # instant-ngp's colour head: the geometry features pass through
    # untouched, the view direction (mapped to [0,1]^3) is SH-encoded.
    "encoding": {"otype": "Composite", "nested": [
        {"otype": "Identity", "n_dims_to_encode": N_FEATURES - 1},
        {"otype": "SphericalHarmonics", "degree": SH_DEGREE,
         "n_dims_to_encode": 3},
    ]},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64,
                "n_hidden_layers": 2, "activation": "ReLU",
                "output_activation": "Sigmoid"},
}
OPTIMIZER = {"otype": "Adam", "learning_rate": 5e-3, "epsilon": 1e-9}


def build_model(policy, generator: Optional[torch.Generator] = None, device=None):
    """(density_net, colour_net): 3 → 16 (24 grid features into a 64 × 1
    MLP) and 18 → 3 (31 encoded features into a 64 × 2 MLP)."""
    density_net = tcnn.create_network_with_input_encoding(
        3, N_FEATURES, DENSITY_CFG["encoding"], DENSITY_CFG["network"],
        policy=policy, generator=generator, device=device)
    color_net = tcnn.create_network_with_input_encoding(
        (N_FEATURES - 1) + 3, 3, COLOR_CFG["encoding"], COLOR_CFG["network"],
        policy=policy, generator=generator, device=device)
    return density_net, color_net


Frac = Union[float, torch.Tensor]


def per_sample_frac(max_level_frac: Frac, n: int, device) -> torch.Tensor:
    """The (n,) float32 level fractions, filled in on ``device`` (a fill
    kernel: no copy from the host, no wait for the device).  A tensor is
    taken to hold them already, as data (JAX passes the fraction to its
    jitted step as a traced value): a captured step reads it from its
    static buffer, where a float would be frozen into the graph."""
    if torch.is_tensor(max_level_frac):
        return max_level_frac
    return torch.full((n,), float(max_level_frac), dtype=torch.float32, device=device)


def model_field(density_net, color_net, x: torch.Tensor, d: torch.Tensor,
                max_level_frac: Optional[Frac] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(σ, rgb) of the learned field at points x viewed from directions d;
    ``max_level_frac`` (a float, or the (B,) fractions of
    ``per_sample_frac``) masks the grid's levels per sample,
    grid.h:69-92."""
    kw = {}
    if max_level_frac is not None:
        kw["max_level_per_element"] = per_sample_frac(max_level_frac, x.shape[0], x.device)
    sigma, color_in = density_heads(density_net(x, **kw), d)
    return sigma, color_net(color_in).float()


def density_heads(h: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """σ = softplus(h[:, 0]) and the colour net's input [h[:, 1:], d/2 + 1/2]
    from the density net's output h (B, 16) and the view directions d."""
    h0 = h[:, 0].float()
    sigma = torch.logaddexp(h0, torch.zeros_like(h0))      # jax.nn.softplus
    return sigma, torch.cat([h[:, 1:].float(), d * 0.5 + 0.5], dim=-1)


# ----------------------------------------------------------- rendering

T_NEAR, T_FAR = 0.05, 1.8


class Transmittance(torch.autograd.Function):
    """cumprod(1 − α + 1e-10) along the samples (the last dim), the
    render's transmittance, as ``torch.cumprod`` computes it (the JAX
    sample's ``jnp.cumprod``), with a backward that reads nothing back to
    the host, so that a step through it can be captured in a CUDA graph:
    autograd's backward of ``torch.cumprod`` asks the device whether any
    factor is 0.

    With factors f (every one at least 1e-10 > 0) and out = cumprod(f),
    d out_j / d f_k = out_j / f_k for j >= k, so the backward is
    flip(cumsum(flip(g·out))) / f, negated for α: the formula torch uses
    where no factor is 0, exact for positive factors.  It differs from the
    exact derivative (and from JAX's, which multiplies the other factors
    and divides by none) only where the fp32 running product underflows:
    an out_j that has flushed to 0, or lost bits as a subnormal (below
    2^-126), drops or blurs the terms g_j · Π_{i≠k} f_i, each below
    2^-126 / f_k <= 1.2e-28 · |g_j|, where the render's weights are far
    below anything a colour can show."""

    @staticmethod
    def forward(ctx, alpha: torch.Tensor) -> torch.Tensor:
        f = 1.0 - alpha + 1e-10
        out = torch.cumprod(f, dim=-1)
        ctx.save_for_backward(f, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        f, out = ctx.saved_tensors
        return -(torch.flip(torch.cumsum(torch.flip(g * out, (-1,)), dim=-1), (-1,)) / f)


def render(field_fn, rays_o: torch.Tensor, rays_d: torch.Tensor, n_samples: int,
           jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quadrature emission-absorption rendering along rays (B, 3).
    ``jitter`` (B, n_samples) in [0, 1) moves each sample within its
    stratum (the JAX sample draws it from its key); without it each
    sample sits at its stratum's middle."""
    b, dev = rays_o.shape[0], rays_o.device
    t = torch.linspace(T_NEAR, T_FAR, n_samples + 1, device=dev)[:-1]
    dt = (T_FAR - T_NEAR) / n_samples
    if jitter is not None:
        t = t + jitter * dt
    else:
        t = (t + 0.5 * dt).expand(b, n_samples)
    x = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]          # (B, S, 3)
    inside = torch.all((x > 0.0) & (x < 1.0), dim=-1)                   # (B, S)
    xq = torch.clamp(x, 1e-6, 1.0 - 1e-6).reshape(-1, 3)
    dq = rays_d[:, None, :].expand(x.shape).reshape(-1, 3)
    sigma, rgb = field_fn(xq, dq)
    sigma = sigma.reshape(b, n_samples) * inside
    rgb = rgb.reshape(b, n_samples, 3)
    alpha = 1.0 - torch.exp(-sigma * dt)                                # (B, S)
    trans = Transmittance.apply(alpha)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha * trans
    out = torch.einsum("bs,bsc->bc", w, rgb)
    return out + trans[:, -1:] * (1.0 - alpha[:, -1:]) * _scene(dev)["background"]


def sample_rays(gen: torch.Generator, batch: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random rays: origins on a radius-1.2 sphere around the volume's
    centre, looking at random points inside the volume."""
    o = torch.randn((batch, 3), generator=gen, device=device)
    o = 0.5 + 1.2 * o / torch.linalg.norm(o, dim=-1, keepdim=True)
    target = torch.rand((batch, 3), generator=gen, device=device) * 0.5 + 0.25
    d = target - o
    return o, d / torch.linalg.norm(d, dim=-1, keepdim=True)


def camera_rays(res: int, device=None, azimuth: float = 0.6, elevation: float = 0.45,
                radius: float = 1.4, fov: float = 0.55) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pinhole camera orbiting the volume's centre, for evaluation renders:
    (res², 3) origins and unit directions, row-major from the top left."""
    f32 = torch.float32
    center = torch.tensor([0.5, 0.5, 0.5], dtype=f32)
    az, el = torch.tensor(azimuth, dtype=f32), torch.tensor(elevation, dtype=f32)
    eye = center + radius * torch.stack([torch.cos(el) * torch.cos(az),
                                         torch.cos(el) * torch.sin(az), torch.sin(el)])
    fwd = (center - eye) / torch.linalg.norm(center - eye)
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0], dtype=f32))
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, fwd)
    px = (torch.arange(res, dtype=f32) + 0.5) / res - 0.5
    u, v = torch.meshgrid(px, -px, indexing="xy")
    d = fwd[None, None] + fov * (u[..., None] * right[None, None] + v[..., None] * up[None, None])
    d = d.reshape(-1, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = eye.expand(d.shape)
    return o.to(device).contiguous(), d.to(device)


# ------------------------------------------------------------ training

def params_and_layout(density_net, color_net):
    """Both nets' parameters and their kinds, by the names of the JAX
    sample's tree ({"density": ..., "color": ...}): "density.encoding.grid",
    "color.network.layers.0", ..."""
    params, layout = {}, {}
    for name, net in (("density", density_net), ("color", color_net)):
        params.update({f"{name}.{n}": p for n, p in net.named_parameters()})
        layout.update({f"{name}.{n}": k for n, k in net.param_layout().items()})
    return params, layout


def loss_fn(density_net, color_net, rays_o, rays_d, n_samples: int,
            jitter: Optional[torch.Tensor] = None, max_level_frac=None) -> torch.Tensor:
    """Mean squared error of the learned field's render against the analytic
    render of the same rays (the JAX sample's ``loss_fn``)."""
    with torch.no_grad():
        gt = render(lambda x, d: true_field(x), rays_o, rays_d, n_samples)
    pred = render(lambda x, d: model_field(density_net, color_net, x, d, max_level_frac),
                  rays_o, rays_d, n_samples, jitter)
    return torch.mean((pred - gt) ** 2)


def loss_and_grads(density_net, color_net, rays_o, rays_d, n_samples: int,
                   jitter: Optional[torch.Tensor] = None, max_level_frac=None):
    """(loss, {name: gradient}) of ``loss_fn``; nothing is updated."""
    params, _ = params_and_layout(density_net, color_net)
    loss = loss_fn(density_net, color_net, rays_o, rays_d, n_samples, jitter, max_level_frac)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def step(density_net, color_net, opt, opt_state, rays_o, rays_d, n_samples: int,
         jitter: Optional[torch.Tensor], max_level_frac) -> torch.Tensor:
    """One training step: the loss's gradients, then Adam in place.
    Returns the loss as a device scalar, without waiting for it."""
    loss, grads = loss_and_grads(density_net, color_net, rays_o, rays_d, n_samples, jitter,
                                 max_level_frac)
    opt.step(opt_state, grads, params_and_layout(density_net, color_net)[0])
    return loss


def coarse_to_fine(i: int, n_steps: int) -> float:
    """Step i's level fraction: the levels unlock linearly over the first
    min(n_steps // 4, 100) steps, then all stay live."""
    warm = min(n_steps // 4, 100)
    return min((i + 1) / max(warm, 1), 1.0) if i < warm else 1.0


def evaluate(density_net, color_net, n_samples: int, res: int, device):
    """(prediction, ground truth) renders of the evaluation camera,
    (res, res, 3) each, in chunks of 2^14 rays, without gradients."""
    rays_o, rays_d = camera_rays(res, device)
    chunk = 1 << 14
    pred, gt = [], []
    with torch.no_grad():
        for s in range(0, rays_o.shape[0], chunk):
            o, d = rays_o[s:s + chunk], rays_d[s:s + chunk]
            pred.append(render(lambda x, vd: model_field(density_net, color_net, x, vd),
                               o, d, n_samples))
            gt.append(render(lambda x, vd: true_field(x), o, d, n_samples * 2))
    return torch.cat(pred).reshape(res, res, 3), torch.cat(gt).reshape(res, res, 3)


def main(argv, device=None) -> dict:
    n_steps = int(argv[1]) if len(argv) > 1 else 400
    batch = 1 << (int(argv[2]) if len(argv) > 2 else 12)
    out_path = argv[3] if len(argv) > 3 else None
    n_samples = int(os.environ.get("NERF_SAMPLES", 48))
    res = int(os.environ.get("NERF_EVAL_RES", 128))

    device = resolve_device(device)
    policy = tcnn.BF16_POLICY if device.type == "cuda" else tcnn.Policy()
    density_net, color_net = build_model(policy, torch.Generator().manual_seed(0), device)
    opt = tcnn.create_optimizer(OPTIMIZER)
    opt_state = opt.init(*params_and_layout(density_net, color_net))
    gen = torch.Generator(device).manual_seed(42)

    def train_step(rays_o, rays_d, jitter, frac):
        return step(density_net, color_net, opt, opt_state, rays_o, rays_d, n_samples,
                    jitter, frac)

    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = None
    for i in range(n_steps):
        rays_o, rays_d = sample_rays(gen, batch, device)
        jitter = torch.rand((batch, n_samples), generator=gen, device=device)
        inputs = (rays_o, rays_d, jitter,
                  per_sample_frac(coarse_to_fine(i, n_steps), batch * n_samples, device))
        if device.type != "cuda":
            loss = train_step(*inputs)
        elif captured is None:
            captured, (loss,) = _capture_step(train_step, inputs)
        else:
            (loss,) = captured(*inputs)
        losses.append(loss)
        if i % max(n_steps // 10, 1) == 0 or i == n_steps - 1:
            print(f"step {i:5d}  loss {float(loss):.6f}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    losses = torch.stack(losses).cpu()
    seconds = time.perf_counter() - t0

    # Evaluation: a held-out camera, PSNR against the analytic render.
    pred, gt = evaluate(density_net, color_net, n_samples, res, device)
    mse = float(torch.mean((pred - gt) ** 2))
    psnr = mse2psnr(mse)
    print(f"eval PSNR {psnr:.2f} dB  (mse {mse:.6f})")
    if out_path:
        write_image(out_path, torch.cat([gt, pred], dim=1).cpu().numpy())
        print(f"wrote {out_path} (left: ground truth, right: learned)")
    return {"losses": losses, "mse": mse, "psnr": psnr, "seconds": seconds}


if __name__ == "__main__":
    main(sys.argv)

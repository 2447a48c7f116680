"""Neural BTF regression, the port's counterpart of ``samples/fit_btf.py``.

    python -m tcnn_tpu_torch.samples.fit_btf [n_steps] [batch_pow]

A BTF (bidirectional texture function) maps (u, v, light dir, view dir)
to reflected RGB.  ``configs/config_btf.json`` encodes the first 4 input
dims with a 4-D CoherentAdd hash grid and the last 2 with OneBlob, into a
FullyFusedMLP 64 x 3.  With no measured BTF bundled, the sample fits
``synthetic_btf``: a spatially varying Blinn-Phong-like reflectance over
6-D inputs (u, v, lx, ly, vx, vy) in [0, 1]^6, the JAX sample's formula
in fp32.  Training runs on the card through ``make_training_loop`` (one
captured CUDA graph replayed per step) in chunks of 50 steps; the model
is then evaluated on 2^16 held-out samples (MSE and relL2, as the JAX
sample does).  Batches come from a ``torch.Generator`` seeded with 0 on
the device, the held-out set from one seeded with 99.
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path
from typing import Callable, Tuple

import torch

import tcnn_tpu_torch as tcnn

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "config_btf.json"
EVAL_SAMPLES = 1 << 16


def _dir_from_xy(xy: torch.Tensor) -> torch.Tensor:
    """(B, 2) in [0, 1]^2 -> unit vectors on the upper hemisphere."""
    d = xy * 2.0 - 1.0
    xz = torch.clamp(1.0 - torch.sum(d * d, dim=-1, keepdim=True), 1e-4, 1.0)
    return torch.cat([d, torch.sqrt(xz)], dim=-1)


def synthetic_btf(x6: torch.Tensor) -> torch.Tensor:
    """Ground-truth BTF (samples/fit_btf.py:44-68): spatially varying
    Blinn-Phong-like reflectance, (B, 6) -> (B, 3)."""
    uv = x6[:, 0:2]
    light = _dir_from_xy(x6[:, 2:4])
    view = _dir_from_xy(x6[:, 4:6])
    h = light + view
    h = h / torch.linalg.norm(h, dim=-1, keepdim=True)

    u, w = uv[:, 0], uv[:, 1]
    albedo = torch.stack([
        0.5 + 0.4 * torch.sin(2 * math.pi * (3 * u + w)),
        0.5 + 0.4 * torch.cos(2 * math.pi * (u - 2 * w)),
        0.4 + 0.3 * torch.sin(2 * math.pi * (5 * u * w + 0.3)),
    ], dim=-1)
    shininess = 5.0 + 60.0 * (0.5 + 0.5 * torch.sin(2 * math.pi * (2 * u + 3 * w)))
    ndl = torch.clamp(light[:, 2], 0.0, 1.0)[:, None]
    ndh = torch.clamp(h[:, 2], 0.0, 1.0)[:, None]
    spec = ndh ** shininess[:, None]
    return albedo * ndl + 0.8 * spec


def batch_sampler(batch: int, device, seed: int = 0
                  ) -> Callable[[int], Tuple[torch.Tensor, torch.Tensor]]:
    """``sample_fn(i) -> (x, synthetic_btf(x))``, x uniform in [0, 1]^6,
    drawn on ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)

    def sample_fn(i: int):
        x = torch.rand((batch, 6), generator=gen, device=device)
        return x, synthetic_btf(x)

    return sample_fn


def evaluate(predict: Callable[[torch.Tensor], torch.Tensor], device,
             n: int = EVAL_SAMPLES, seed: int = 99) -> Tuple[float, float]:
    """(MSE, relL2) of ``predict`` on n held-out samples, relL2 =
    mean((pred − y)² / (y² + 0.01)) as in the JAX sample (:93-104)."""
    gen = torch.Generator(device).manual_seed(seed)
    xe = torch.rand((n, 6), generator=gen, device=device)
    ye = synthetic_btf(xe)
    pred = predict(xe).float()
    mse = float(torch.mean((pred - ye) ** 2))
    rel = float(torch.mean((pred - ye) ** 2 / (ye ** 2 + 0.01)))
    return mse, rel


def main(argv, device=None) -> dict:
    n_steps = int(argv[1]) if len(argv) > 1 else 1000
    batch = 1 << (int(argv[2]) if len(argv) > 2 else 16)

    model = tcnn.create_from_config(6, 3, CONFIG, policy=tcnn.BF16_POLICY,
                                    device=device)
    device = next(model.network.parameters()).device
    print(f"BTF model: n_params={model.trainer.n_params()} on {device}")

    chunk = min(50, n_steps)
    n_loops = max(n_steps // chunk, 1)
    n_steps = n_loops * chunk            # steps actually run
    loop = model.trainer.make_training_loop(batch_sampler(batch, device), chunk)
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_loops):
        losses.append(loop())
        if i % 4 == 0:
            print(f"step {(i + 1) * chunk}: loss={float(losses[-1][-1]):.6f}", flush=True)
    losses = torch.cat(losses).cpu()
    dt = time.perf_counter() - t0

    mse, rel = evaluate(model.trainer.inference, device)
    _, rel_zero = evaluate(lambda x: x.new_zeros((x.shape[0], 3)), device)
    first, last10 = float(losses[0]), float(losses[-10:].mean())
    print(f"{n_steps} steps in {dt:.2f}s ({n_steps * batch / dt:.3e} samples/s) "
          f"loss {first:.6f} -> {last10:.6f} (mean of the last 10) "
          f"held-out MSE={mse:.6f} relL2={rel:.6f} (zero prediction: {rel_zero:.6f})")
    return {"losses": losses, "mse": mse, "rel": rel, "rel_zero": rel_zero}


if __name__ == "__main__":
    main(sys.argv)

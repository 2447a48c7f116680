"""Image fitting through the PyTorch modules: the port's counterpart of
``samples/mlp_learning_an_image_pytorch.py`` (the CUDA original's
``samples/mlp_learning_an_image_pytorch.py``).

    python -m tcnn_tpu_torch.samples.mlp_learning_an_image_pytorch [image.jpg] [n_steps] [batch_pow]

The same model as the JAX sample, a ``bindings.torch_interop.
NetworkWithInputEncoding`` (a 2-D HashGrid of 16 levels x 2 features,
2^15-row tables, base 16, scale 1.5, into a FullyFusedMLP 64 x 2, fp32),
trained by ``torch.optim.Adam`` at lr 0.01 on the manual relative L2 of
the original sample, 2^batch_pow pixels a step (2^14 by default, the JAX
sample's batch).  The image (``utils.image.bench_image`` when no path is
given or it does not exist), its pixel centres and the batches drawn from
them stay on the device.  Every step runs eagerly, as the original's does.
The loss is printed every 10 steps (every 100 from step 100); at steps 10,
100 and 1000 the PSNR of the whole image is printed and the prediction
dumped as ``<step>_pytorch.jpg``.  ``device="cpu"`` runs the plain
versions of the kernels.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from tcnn_tpu_torch.bindings import torch_interop as tcnn_torch
from tcnn_tpu_torch.common import resolve_device
from tcnn_tpu_torch.utils.image import bench_image, load_image, mse2psnr

ENCODING = {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
            "log2_hashmap_size": 15, "base_resolution": 16, "per_level_scale": 1.5}
NETWORK = {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2,
           "activation": "ReLU", "output_activation": "None"}
DUMP_AT = (10, 100, 1000)


def write_image(path: str, img: np.ndarray) -> None:
    """The JAX sample's dump: 8-bit RGB through PIL, else the 8-bit array
    as ``<path>.npy``."""
    arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
    except ImportError:
        np.save(path + ".npy", arr)


def pixel_centres(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(h·w, 2) float32 (x, y) pixel centres in [0, 1], row-major, rounded
    from float64 as the JAX sample's numpy computes them."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device),
                            indexing="ij")
    return torch.stack([(xs.reshape(-1) + 0.5) / w, (ys.reshape(-1) + 0.5) / h],
                       dim=-1).float()


def main(argv, device=None, out_dir: str = ".") -> dict:
    image_path = argv[1] if len(argv) > 1 else None
    n_steps = int(argv[2]) if len(argv) > 2 else 1000
    batch_size = 1 << (int(argv[3]) if len(argv) > 3 else 14)
    device = resolve_device(device)

    if image_path and os.path.exists(image_path):
        img = load_image(image_path)
    else:
        img, _name = bench_image()
    h, w = img.shape[:2]

    model = tcnn_torch.NetworkWithInputEncoding(
        n_input_dims=2, n_output_dims=3, encoding_config=ENCODING, network_config=NETWORK,
        device=device)
    print(model)
    optimizer = torch.optim.Adam(model.parameters(), lr=0.01)

    target_full = torch.from_numpy(np.asarray(img, np.float32).reshape(-1, 3)).to(device)
    coords_full = pixel_centres(h, w, device)
    gen = torch.Generator(device).manual_seed(1337)

    def psnr_full() -> tuple:
        with torch.no_grad():
            pred = model(coords_full).clamp(0, 1)
        return mse2psnr(float(torch.mean((pred - target_full) ** 2))), pred

    losses, psnrs = [], {}
    interval = 10
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = prev_t = time.perf_counter()
    for i in range(1, n_steps + 1):
        idx = torch.randint(0, h * w, (batch_size,), generator=gen, device=device)
        xy, rgb = coords_full[idx], target_full[idx]

        pred = model(xy)
        # Manual relative L2, exactly as the original torch sample.
        relative_l2_error = (pred - rgb) ** 2 / (pred.detach() ** 2 + 0.01)
        loss = relative_l2_error.mean()

        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())

        if i % interval == 0:
            now = time.perf_counter()
            print(f"Step#{i}: loss={loss.item():.6f} time={1e6 * (now - prev_t):.0f}[µs]")
            prev_t = now
            if i >= 100:
                interval = 100

        if i in DUMP_AT:
            psnrs[i], full = psnr_full()
            print(f"  PSNR@{i}: {psnrs[i]:.2f} dB")
            write_image(os.path.join(out_dir, f"{i}_pytorch.jpg"),
                        full.reshape(h, w, 3).cpu().numpy())

    if device.type == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"Finished {n_steps} steps in {total:.2f}s")
    return {"losses": torch.stack(losses).cpu() if losses else torch.zeros(0),
            "psnr_at": psnrs, "seconds": total}


if __name__ == "__main__":
    main(sys.argv)

"""Image fitting, the reference's flagship demo
(samples/mlp_learning_an_image.cu): the port's counterpart of
``samples/mlp_learning_an_image.py``.

    python -m tcnn_tpu_torch.samples.mlp_learning_an_image [image.jpg] [config.json] [n_steps]

Learns (x, y) → RGB from one image with a config-driven model
(``configs/config_hash.json`` by default, ``BF16_POLICY``, 2^18 samples a
step), printing the loss, time and throughput every 10 steps (every 100
from step 100) and the PSNR of the whole image at steps 10, 100 and 1000,
where it also dumps the prediction as ``<step>.jpg``, as the JAX sample
does.  The steps run through ``Trainer.make_training_loop``: on the card
one captured CUDA graph replayed per step, one call per stretch between
two prints.  Without an image path (or one that does not exist) it fits
``synthetic_image(1024, 1024)``.  ``device="cpu"`` runs the plain
versions eagerly.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

import tcnn_tpu_torch as tcnn
from tcnn_tpu_torch.common import resolve_device
from tcnn_tpu_torch.utils.image import ImageSampler, load_image, mse2psnr, synthetic_image

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DUMP_AT = (10, 100, 1000)


def write_image(path: str, img: np.ndarray) -> None:
    """The sample's dump: 8-bit RGB through PIL, or, without PIL, the float
    image as ``<path>.npy`` (the JAX sample's own writer)."""
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image

        Image.fromarray(img8).save(path)
        return
    except ImportError:
        pass
    np.save(path + ".npy", img)


def main(argv, device=None, out_dir: str = ".", batch_pow: int = 18) -> dict:
    image_path = argv[1] if len(argv) > 1 else None
    config_path = argv[2] if len(argv) > 2 else os.path.join(
        _REPO, "configs", "config_hash.json")
    n_steps = int(argv[3]) if len(argv) > 3 else 1000
    batch_size = 1 << batch_pow

    device = resolve_device(device)
    if image_path and os.path.exists(image_path):
        img = load_image(image_path)
    else:
        print("No image given; using synthetic 1024x1024 test image")
        img = synthetic_image(1024, 1024)
    sampler = ImageSampler(img, device=device)
    print(f"Image: {sampler.width}x{sampler.height}")

    model = tcnn.create_from_config(2, 3, config_path, policy=tcnn.BF16_POLICY,
                                    device=device)
    trainer = model.trainer
    print(f"Model: {model.network.hyperparams()}")
    print(f"n_params: {trainer.n_params()}")

    coords = sampler.full_grid_coords()
    ref = sampler.image.reshape(-1, 3)

    def predict_full(chunk: int = 1 << 18) -> torch.Tensor:
        """The whole image's prediction in chunks of the training batch's size."""
        return torch.cat([trainer.inference(coords[i:i + chunk]).float()
                          for i in range(0, coords.shape[0], chunk)])

    def sample(i):
        return sampler.sample_batch(batch_size)

    psnrs = {}
    losses = []
    interval = 10
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_start = prev_t = time.perf_counter()
    i = 0
    while i < n_steps:
        # steps up to the next print, in one call of the loop
        n = min(interval - i % interval, n_steps - i)
        loss = trainer.make_training_loop(sample, n)()
        losses.append(loss)
        i += n
        if i % interval == 0:
            last = float(loss[-1])   # waits for the device
            now = time.perf_counter()
            print(f"Step#{i}: loss={last:.6f} time={1e6 * (now - prev_t):.0f}[µs] "
                  f"throughput={n * batch_size / (now - prev_t):.2e}[samples/s]")
            prev_t = now
            if i >= 100:
                interval = 100
        if i in DUMP_AT:
            pred = predict_full()
            psnrs[i] = mse2psnr(float(torch.mean((pred - ref) ** 2)))
            print(f"  PSNR@{i}: {psnrs[i]:.2f} dB")
            write_image(os.path.join(out_dir, f"{i}.jpg"),
                        pred.reshape(sampler.height, sampler.width, 3).cpu().numpy())

    total = time.perf_counter() - t_start
    pred = predict_full()
    final = mse2psnr(float(torch.mean((pred - ref) ** 2)))
    print(f"Finished {n_steps} steps in {total:.2f}s "
          f"({n_steps * batch_size / total:.2e} samples/s), final PSNR {final:.2f} dB")
    return {"losses": torch.cat(losses).cpu() if losses else torch.zeros(0),
            "psnr": final, "psnr_at": psnrs, "seconds": total}


if __name__ == "__main__":
    main(sys.argv)

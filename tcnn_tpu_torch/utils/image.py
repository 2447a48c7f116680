"""Synthetic image and on-device pixel sampling for the image-fit workloads.

PyTorch counterpart of ``tcnn_tpu/utils/image.py:84-244`` (the
reference's texture sampler, samples/mlp_learning_an_image.cu:101-160).
``synthetic_image`` is a copy of the JAX package's numpy function, so both
packages fit the same picture (the committed
``benchmarks/data/fixture.png`` is its 1024 × 1024 render).  Loading
image files waits for a later slice: it needs PIL.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..common import resolve_device


def synthetic_image(height: int = 512, width: int = 512,
                    seed: int = 0) -> np.ndarray:
    """Deterministic synthetic test image with multi-scale structure
    (smooth gradients + mid-frequency waves + sharp edges) so that both
    coarse and fine hash-grid levels have signal to fit."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    u, v = xs / width, ys / height
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = 0.5 + 0.5 * np.sin(2 * np.pi * (3 * u + v))
    img[..., 1] = 0.5 + 0.5 * np.cos(2 * np.pi * (u - 2 * v) + 1.0)
    img[..., 2] = u * v
    # mid frequencies
    for c in range(3):
        fx, fy = rng.randint(5, 20, 2)
        ph = rng.uniform(0, 2 * np.pi)
        img[..., c] += 0.15 * np.sin(2 * np.pi * (fx * u + fy * v) + ph)
    # sharp circles
    for _ in range(6):
        cx, cy, r = rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.2)
        mask = ((u - cx) ** 2 + (v - cy) ** 2) < r ** 2
        img[mask] += rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(max(mse, 1e-12)))


class ImageSampler:
    """Pixel sampler with the image on the device.

    As in the JAX package, the default is shuffled-epoch sampling: at
    construction every texel centre (xy, rgb) is written into a pool in a
    random order (``torch.randperm`` from a generator seeded with
    ``seed``), and each batch is a contiguous window of the pool at a
    random offset.  The offset is drawn on the host from a second seeded
    generator, so drawing a batch never waits for the device and the
    window is a view, copied by nobody.  ``sample_batch_bilinear`` keeps
    the reference's sampling (random uvs, bilinear filter);
    ``sample_at`` filters at arbitrary coordinates.
    """

    def __init__(self, image: np.ndarray, pool: bool = True, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.image = torch.as_tensor(np.asarray(image, np.float32)).to(self.device)
        self.height, self.width = self.image.shape[:2]
        self._host_gen = torch.Generator().manual_seed(seed)
        self._device_gen = torch.Generator(self.device).manual_seed(seed)
        self._pool_xy: Optional[torch.Tensor] = None
        self._pool_rgb: Optional[torch.Tensor] = None
        if pool:
            self._build_pool(seed)

    def _build_pool(self, seed: int) -> None:
        h, w = self.height, self.width
        n = h * w
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
        perm = perm.to(self.device)
        ys, xs = perm // w, perm % w
        u = (xs.float() + 0.5) / w
        v = (ys.float() + 0.5) / h
        self._pool_xy = torch.stack([u, v], dim=-1)
        self._pool_rgb = self.image.reshape(n, -1)[perm]

    def sample_at(self, xy: torch.Tensor) -> torch.Tensor:
        """Bilinear lookup at normalised coords (B, 2) [x, y] in [0, 1],
        texel-centre convention, clamp to edge."""
        img = self.image
        h, w = self.height, self.width
        fx = xy[:, 0] * w - 0.5
        fy = xy[:, 1] * h - 0.5
        x0f = torch.floor(fx)
        y0f = torch.floor(fy)
        tx = (fx - x0f)[:, None]
        ty = (fy - y0f)[:, None]
        x0i = x0f.long()
        y0i = y0f.long()
        x0 = x0i.clamp(0, w - 1)
        y0 = y0i.clamp(0, h - 1)
        x1 = (x0i + 1).clamp(0, w - 1)
        y1 = (y0i + 1).clamp(0, h - 1)
        c00, c01 = img[y0, x0], img[y0, x1]
        c10, c11 = img[y1, x0], img[y1, x1]
        return ((1 - ty) * ((1 - tx) * c00 + tx * c01)
                + ty * ((1 - tx) * c10 + tx * c11))

    def pool_data(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._pool_xy is None:
            raise ValueError("sampler built with pool=False")
        return self._pool_xy, self._pool_rgb

    def sample_from_pool(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A contiguous window of n pool entries at a random offset."""
        pool_xy, pool_rgb = self.pool_data()
        pn = pool_xy.shape[0]
        if n >= pn:
            # The batch exceeds the pool (tiny images in tests): wrap around.
            off = int(torch.randint(0, pn, (), generator=self._host_gen))
            idx = (off + torch.arange(n, device=self.device)) % pn
            return pool_xy[idx], pool_rgb[idx]
        # The upper bound is exclusive: off == pn - n reaches the last entry.
        off = int(torch.randint(0, pn - n + 1, (), generator=self._host_gen))
        return pool_xy[off:off + n], pool_rgb[off:off + n]

    def sample_batch(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(xy, rgb) training batch: a pool window, or without a pool the
        reference's bilinear sampling."""
        if self._pool_xy is None:
            return self.sample_batch_bilinear(n)
        return self.sample_from_pool(n)

    def sample_batch_bilinear(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform random uvs and a bilinear filter
        (mlp_learning_an_image.cu:229-243)."""
        xy = torch.rand((n, 2), generator=self._device_gen, device=self.device)
        return xy, self.sample_at(xy)

    def full_grid_coords(self) -> torch.Tensor:
        """Pixel-centre coords of the full image, row-major
        (mlp_learning_an_image.cu:190-204)."""
        ys, xs = torch.meshgrid(torch.arange(self.height, device=self.device),
                                torch.arange(self.width, device=self.device),
                                indexing="ij")
        u = (xs.float() + 0.5) / self.width
        v = (ys.float() + 0.5) / self.height
        return torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)

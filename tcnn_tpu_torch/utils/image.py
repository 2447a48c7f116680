"""Image IO, the synthetic image and on-device pixel sampling for the
image-fit workloads.

PyTorch counterpart of ``tcnn_tpu/utils/image.py`` (the reference's
texture sampler, samples/mlp_learning_an_image.cu:101-160, and the image
helpers of its scripts/common.py).  ``synthetic_image`` is a copy of the
JAX package's numpy function, so both packages fit the same picture (the
committed ``benchmarks/data/fixture.png`` is its 1024 × 1024 render).
Image files are read and written as the JAX package does, on the host in
numpy: with PIL where it is installed, else imageio, else ``load_image``
raises (``bench_image`` then falls back to ``synthetic_image``) and
``write_image`` fails on the import of imageio.  No image codec is
written here.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_image(path: str) -> np.ndarray:
    """An image file as float32 (H, W, 3) in [0, 1] (``load_image``,
    image.py:21-44): PIL if available, else imageio, else RuntimeError."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    except ImportError:
        pass
    try:
        import imageio.v2 as imageio

        img = np.asarray(imageio.imread(path), np.float32)
        if img.max() > 1.0:
            img = img / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        return img[..., :3]
    except ImportError as e:
        raise RuntimeError(
            "No image library available (PIL/imageio); use synthetic_image()") from e


def bench_image() -> Tuple[np.ndarray, str]:
    """The sample's fixture image and a short name of where it came from
    (``bench_image``, image.py:47-81), the first that loads of:

      1. ``$TCNN_TPU_BENCH_IMAGE`` (any readable image path; the reference
         checkout's photo, for instance);
      2. the repo's committed ``benchmarks/data/fixture.png`` (a 1024 ×
         1024 render of :func:`synthetic_image`);
      3. :func:`synthetic_image` (1024, 1024) in memory, which is where a
         host without PIL and imageio ends.
    """
    candidates = []
    env = os.environ.get("TCNN_TPU_BENCH_IMAGE")
    if env:
        candidates.append((env, os.path.basename(env)))
    candidates.append((os.path.join(_REPO, "benchmarks", "data", "fixture.png"),
                       "fixture.png"))
    for path, name in candidates:
        if os.path.exists(path):
            try:
                return load_image(path), name
            except Exception:
                continue
    return synthetic_image(1024, 1024), "synthetic-1024"


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


# ---------------------------------------------------------------------------
# scripts/common.py's colour-space conversions and its fp16 ``.bin`` format
# (common.py:52-91; image.py:254-339), on numpy arrays on the host.
# ---------------------------------------------------------------------------


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """Inverse sRGB gamma (common.py:52-54)."""
    img = np.asarray(img, np.float32)
    return np.where(img > 0.04045, np.power((img + 0.055) / 1.055, 2.4), img / 12.92)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """sRGB gamma (common.py:56-58)."""
    img = np.asarray(img, np.float32)
    return np.where(img > 0.0031308,
                    1.055 * np.power(np.maximum(img, 0.0), 1.0 / 2.4) - 0.055,
                    12.92 * img)


def read_image(path: str) -> np.ndarray:
    """An image as LINEAR float32 (H, W, C).  ``.bin`` is the reference's
    raw format (an (h, w) int32 header, then h·w·4 fp16 values, already
    linear); any other file is decoded and converted sRGB → linear, with
    alpha premultiplied where a 4th channel is present."""
    if os.path.splitext(path)[1] == ".bin":
        with open(path, "rb") as f:
            data = f.read()
        h, w = struct.unpack("ii", data[:8])
        return (np.frombuffer(data, np.float16, count=h * w * 4, offset=8)
                .astype(np.float32).reshape(h, w, 4))
    img = _read_image_u8(path)
    if img.shape[2] == 4:
        img = img.copy()
        img[..., :3] = srgb_to_linear(img[..., :3]) * img[..., 3:4]
        return img
    return srgb_to_linear(img)


def write_image(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write a LINEAR float32 (H, W, C) image: ``.bin`` as raw fp16 padded
    to 4 channels; any other extension un-premultiplies alpha, converts
    linear → sRGB and quantises to 8 bits (PIL, else imageio)."""
    img = np.asarray(img, np.float32)
    if os.path.splitext(path)[1] == ".bin":
        if img.shape[2] < 4:
            pad = np.ones(img.shape[:2] + (4 - img.shape[2],), np.float32)
            img = np.concatenate([img, pad], axis=2)
        with open(path, "wb") as f:
            f.write(struct.pack("ii", img.shape[0], img.shape[1]))
            f.write(img.astype(np.float16).tobytes())
        return
    if img.shape[2] == 4:
        img = img.copy()
        a = img[..., 3:4]
        img[..., :3] = linear_to_srgb(
            np.divide(img[..., :3], a, out=np.zeros_like(img[..., :3]), where=a != 0))
    else:
        img = linear_to_srgb(img)
    _write_image_u8(path, img, quality)


def _read_image_u8(path: str) -> np.ndarray:
    """Decode to float32 (H, W, C) in [0, 1], alpha kept."""
    try:
        from PIL import Image

        arr = np.asarray(Image.open(path), np.float32) / 255.0
    except ImportError:
        import imageio.v2 as imageio

        arr = np.asarray(imageio.imread(path), np.float32)
        if arr.max() > 1.0:
            arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _write_image_u8(path: str, img: np.ndarray, quality: int) -> None:
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg") and u8.ndim == 3 and u8.shape[2] > 3:
        u8 = u8[:, :, :3]
    if u8.shape[2] == 1:
        u8 = u8[:, :, 0]
    try:
        from PIL import Image

        Image.fromarray(u8).save(
            path, **({"quality": quality, "subsampling": 0}
                     if ext in (".jpg", ".jpeg") else {}))
    except ImportError:
        import imageio.v2 as imageio

        imageio.imwrite(path, u8)

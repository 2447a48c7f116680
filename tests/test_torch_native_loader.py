"""The port's native C++ loader on the CPU (``utils/native_loader.py``).

Its library is built from the port's own copy of the C++ source with g++
into ``build/native/`` (the tests skip where that fails, decided inside a
fixture).  Against the JAX package's loader (``tcnn_tpu.utils.
native_loader``, its own build): the same samples bit for bit on the same
seed, both libraries built with the same flags from the same code.
Against the port's ``ImageSampler.sample_at``: within 2e-6 (the C++ and
PyTorch bilinear fetches round in other places), as the JAX package's
test holds its loader against its sampler.
"""

import ctypes
import multiprocessing
import os
import shutil

import numpy as np
import pytest
import torch

from tcnn_tpu_torch.utils import native_loader as nl
from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image


@pytest.fixture(scope="module")
def img():
    try:
        nl.load_library()
    except Exception as e:   # no g++ on this host
        pytest.skip(f"native toolchain unavailable: {e}")
    return synthetic_image(64, 48)


def test_samples_equal_the_jax_packages_bit_for_bit(img):
    from tcnn_tpu.utils import native_loader as jnl

    try:
        jnl.load_library()
    except Exception as e:
        pytest.skip(f"the JAX package's native loader does not build here: {e}")
    for seed, n in ((42, 10000), (7, 50000)):
        xy, v = nl.NativeImageSampler(img, n_threads=3).sample(n, seed)
        jxy, jv = jnl.NativeImageSampler(img, n_threads=5).sample(n, seed)
        np.testing.assert_array_equal(xy.numpy(), jxy)
        np.testing.assert_array_equal(v.numpy(), jv)
    gxy, gv = nl.NativeImageSampler(img).full_grid()
    jgxy, jgv = jnl.NativeImageSampler(img).full_grid()
    np.testing.assert_array_equal(gxy.numpy(), jgxy)
    np.testing.assert_array_equal(gv.numpy(), jgv)


def test_samples_match_the_ports_image_sampler(img):
    xy, v = nl.NativeImageSampler(img).sample(4096, seed=3)
    assert xy.dtype == v.dtype == torch.float32 and xy.shape == (4096, 2)
    assert float(xy.min()) >= 0.0 and float(xy.max()) < 1.0
    want = ImageSampler(img, device="cpu").sample_at(xy)
    np.testing.assert_allclose(v.numpy(), want.numpy(), atol=2e-6, rtol=0)
    out = (torch.empty(4096, 2), torch.empty(4096, 3))
    got = nl.NativeImageSampler(img).sample(4096, seed=3, out=out)
    assert got[0] is out[0] and torch.equal(out[1], v)


def _build_into(path):
    nl.build(path)
    return os.path.getsize(path)


def test_two_concurrent_builds_into_one_directory(tmp_path):
    """Two processes build the library to one path at once: each writes a
    temporary file and renames it into place, so the path always holds a
    whole library and no temporary file is left."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    path = tmp_path / "libtcnn_loader.so"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2) as pool:
        sizes = pool.map(_build_into, [path, path])
    assert sizes[0] > 0 and sizes[1] > 0
    assert sorted(os.listdir(tmp_path)) == ["libtcnn_loader.so"]
    assert ctypes.CDLL(str(path)).tcnn_loader_abi_version() == nl.ABI_VERSION


def test_prefetching_sampler_on_the_cpu(img):
    s = nl.NativeImageSampler(img)
    pf = nl.PrefetchingSampler(s, batch_size=1024, seed=5, depth=2, device="cpu")
    try:
        batches = [next(pf) for _ in range(4)]
    finally:
        pf.close()
    for i, (xy, v) in enumerate(batches):
        want_xy, want_v = s.sample(1024, 5 * 1_000_003 + i)
        assert torch.equal(xy, want_xy) and torch.equal(v, want_v)
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            nl.PrefetchingSampler(s, batch_size=16)

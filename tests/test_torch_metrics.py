"""The port's error metrics and profiling hooks on the CPU.

``tcnn_tpu_torch.utils.metrics`` against ``tcnn_tpu.utils.metrics`` on
the same float32 images: the per-element maps within 1e-6 relative (the
same float32 operations; XLA and PyTorch may fuse them differently), the
means within 1e-6 relative (float32 sums in another order), ``trim`` and
``luminance`` exactly (both numpy).  ``profiling``: ``Timer`` and ``trace``
on the CPU, where ``device_memory_stats`` is ``{}``, as JAX's is where
the device reports none.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnn_tpu.utils import metrics as jmetrics
from tcnn_tpu_torch.utils import metrics, profiling

MAPS = ["L1", "APE", "SAPE", "MSE", "RSE"]
MEANS = ["MAE", "MAPE", "SMAPE", "mean_MSE", "MRSE", "psnr"]


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 1, (32, 24, 3)).astype(np.float32)
    img = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1).astype(np.float32)
    return img, ref


@pytest.mark.parametrize("name", MAPS)
def test_per_element_metrics_equal_jax(images, name):
    img, ref = images
    got = getattr(metrics, name)(torch.from_numpy(img), torch.from_numpy(ref))
    want = np.asarray(getattr(jmetrics, name)(jnp.asarray(img), jnp.asarray(ref)))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", MEANS)
def test_mean_metrics_equal_jax(images, name):
    img, ref = images
    got = getattr(metrics, name)(torch.from_numpy(img), torch.from_numpy(ref))
    want = getattr(jmetrics, name)(jnp.asarray(img), jnp.asarray(ref))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # bf16 inputs are computed in float32, as the port's tensors may come
    low = getattr(metrics, name)(torch.from_numpy(img).bfloat16(), torch.from_numpy(ref))
    assert np.isfinite(low)


def test_trim_luminance_and_mse2psnr_equal_jax(images):
    img, ref = images
    err = np.abs(img - ref)
    assert metrics.trim(torch.from_numpy(err), 0.01) == jmetrics.trim(err, 0.01)
    np.testing.assert_array_equal(metrics.luminance(torch.from_numpy(img)),
                                  jmetrics.luminance(img))
    for mse in (1e-3, 0.25, 0.0):
        assert metrics.mse2psnr(mse) == jmetrics.mse2psnr(mse)


def test_profiling_timer_trace_and_memory_stats(tmp_path):
    with profiling.Timer() as t:
        a = torch.ones(256, 256) @ torch.ones(256, 256)
    assert t.seconds > 0 and float(a[0, 0]) == 256.0
    with profiling.trace(str(tmp_path)) as prof:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert prof.trace_file == os.path.join(str(tmp_path), "trace.json")
    assert os.path.getsize(prof.trace_file) > 0
    split = profiling.split(prof, top=3)
    assert split["device_ms"] == 0.0 and split["cpu_ms"] > 0
    assert len(split["top_cpu"]) == 3 and any("mm" in name for name, _, _ in split["top_cpu"])
    assert profiling.device_memory_stats("cpu") == {}
    assert profiling.throughput(1000, 0.5) == 2000.0
    profiling.set_verbose(True)
    assert profiling.log.name == "tcnn_tpu_torch" and profiling.log.level == 10
    profiling.set_verbose(False)

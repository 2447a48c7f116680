"""Error metrics (``tcnn_tpu/utils/metrics.py``, scripts/common.py:32-149).

The per-element maps (``L1``, ``APE``, ``SAPE``, ``MSE``, ``RSE``) return
tensors on the inputs' device; the means (``MAE`` ... ``MRSE``, ``psnr``)
return Python floats, and reading one back waits for the device.  Inputs
are tensors or arrays, computed in float32 (bf16 inputs too), as the JAX
package computes its float32 arrays.  ``trim`` and ``luminance`` stay on
numpy, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import mse2psnr

__all__ = ["L1", "APE", "SAPE", "MSE", "RSE", "MAE", "MAPE", "SMAPE", "mean_MSE", "MRSE",
           "mse2psnr", "psnr", "trim", "luminance"]


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).float()


def L1(img, ref) -> torch.Tensor:
    return (_f32(img) - _f32(ref)).abs()


def APE(img, ref) -> torch.Tensor:   # absolute percentage error
    return L1(img, ref) / (1e-2 + _f32(ref).abs())


def SAPE(img, ref) -> torch.Tensor:   # symmetric APE
    return L1(img, ref) / (1e-2 + (_f32(ref).abs() + _f32(img).abs()) / 2)


def MSE(img, ref) -> torch.Tensor:
    return (_f32(img) - _f32(ref)) ** 2


def RSE(img, ref) -> torch.Tensor:   # relative squared error
    r = _f32(ref)
    return MSE(img, ref) / (1e-2 + r * r)


def MAE(img, ref) -> float:
    return float(L1(img, ref).mean())


def MAPE(img, ref) -> float:
    return float(APE(img, ref).mean())


def SMAPE(img, ref) -> float:
    return float(SAPE(img, ref).mean())


def mean_MSE(img, ref) -> float:
    return float(MSE(img, ref).mean())


def MRSE(img, ref) -> float:
    return float(RSE(img, ref).mean())


def psnr(img, ref) -> float:
    """Peak signal-to-noise ratio in dB of ``img`` against ``ref``, both
    in [0, 1]: -10 log10(mean squared error)."""
    return mse2psnr(mean_MSE(img, ref))


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def trim(error, skip: float = 1e-6):
    """Mean of the error array with the extreme ``skip`` fraction of
    values dropped from each tail (common.py:93-97)."""
    err = np.sort(_numpy(error).ravel())
    k = int(skip * err.size)
    return err[k:err.size - k].mean()


def luminance(a):
    """Rec.709 luma of a gamma-1/2.2-encoded copy (common.py:99-101)."""
    a = np.maximum(0, _numpy(a)) ** 0.4545454545
    return (0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2])

"""Error metrics (``tcnn_tpu/utils/metrics.py``, scripts/common.py:32-149).

The port has the one its tests and ``chip_smoke.py`` use; reading the
value back waits for the device.
"""

from __future__ import annotations

import torch

from .image import mse2psnr


def psnr(img: torch.Tensor, ref: torch.Tensor) -> float:
    """Peak signal-to-noise ratio in dB of ``img`` against ``ref``, both
    in [0, 1]: -10 log10(mean squared error)."""
    return mse2psnr(float(((img.float() - ref.float()) ** 2).mean()))

"""Distortion losses (counterpart of ``crdr_tpu/losses/distortion_loss.py``;
reference src/losses/distortion_loss.py) on [-1, 1] NCHW images."""

from __future__ import annotations

import torch

from ..utils.img_utils import ms_ssim
from ..utils.registry import LOSS_REGISTRY


@LOSS_REGISTRY.register()
class MSELoss:
    """weight * MSE on rescaled images; CRDR: weight 150, scale [0, 1]."""

    def __init__(self, loss_weight: float, normalize_img: bool = True,
                 mse_scale: str = "0_1"):
        if not normalize_img or mse_scale not in ("0_255", "0_1"):
            raise ValueError(f"MSELoss: normalize_img={normalize_img}, "
                             f"mse_scale={mse_scale!r}")
        self.lamb = loss_weight
        self.scale = 255.0 if mse_scale == "0_255" else 1.0

    def __call__(self, real_images, fake_images, **kwargs):
        r = (real_images + 1.0) / 2.0 * self.scale
        f = (fake_images + 1.0) / 2.0 * self.scale
        return self.lamb * torch.mean((r - f) ** 2)


@LOSS_REGISTRY.register()
class L1Loss:
    def __init__(self, loss_weight: float):
        self.lamb = loss_weight

    def __call__(self, real_images, fake_images, **kwargs):
        return self.lamb * torch.mean(torch.abs(real_images - fake_images))


@LOSS_REGISTRY.register()
class MSSSIMLoss:
    """weight * (1 - MS-SSIM) on [0, 1] images."""

    def __init__(self, loss_weight: float):
        self.lamb = loss_weight

    def __call__(self, real_images, fake_images, **kwargs):
        r = (real_images + 1.0) / 2.0
        f = (fake_images + 1.0) / 2.0
        return self.lamb * (1.0 - torch.mean(ms_ssim(r, f)))

"""Cheng 2020 residual blocks with GDN / IGDN options (reference
cheng_resblock.py; counterpart of ``crdr_tpu/nn/resblock.py``), NCHW.

Submodules carry the flax names (``conv1``, ``actv1``, ``c1_up``,
``shortcut_up``, ...); a GDN activation is the port's ``GDN`` under
``actvN.gdn`` / ``actvN.igdn``, so on the card it runs K3.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv2d
from .norm import GDN


class _Actv(nn.Module):
    def __init__(self, kind: Optional[str], ch: int):
        super().__init__()
        self.kind = kind
        if kind == "gdn":
            self.gdn = GDN(ch)
        elif kind == "igdn":
            self.igdn = GDN(ch, inverse=True)
        elif kind not in (None, "relu", "lrelu"):
            raise ValueError(f"unknown actv {kind}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind is None:
            return x
        if self.kind == "relu":
            return torch.relu(x)
        if self.kind == "lrelu":
            return F.leaky_relu(x, 0.2)
        return getattr(self, self.kind)(x)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, actv: Optional[str] = "relu",
                 actv2: Optional[str] = None, downscale: bool = False,
                 kernel_size: int = 3):
        super().__init__()
        stride = 2 if downscale else 1
        pad = (kernel_size - 1) // 2
        if downscale or in_ch != out_ch:
            self.shortcut = Conv2d(in_ch, out_ch, 1, stride, 0)
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_ch, out_ch, kernel_size, stride, pad)
        self.actv1 = _Actv(actv, out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, kernel_size, 1, pad)
        self.actv2 = _Actv(actv2, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = self.actv2(self.conv2(self.actv1(self.conv1(x))))
        return y + shortcut


class _UpConvPS(nn.Module):
    """conv(k) -> PixelShuffle(2) (the reference's 'pixelshuffle' up mode)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch * 4, kernel_size, 1,
                           (kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(self.conv(x), 2)


class _UpConvInterp(nn.Module):
    """conv(k) -> nearest 2x upsample."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, 1,
                           (kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(self.conv(x), scale_factor=2, mode="nearest")


class UpResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 actv: str = "relu", actv2: Optional[str] = None,
                 up_type: str = "pixelshuffle"):
        super().__init__()
        up = _UpConvPS if up_type == "pixelshuffle" else _UpConvInterp
        self.c1_up = up(in_ch, out_ch, kernel_size)
        self.actv1 = _Actv(actv, out_ch)
        self.c1_conv = Conv2d(out_ch, out_ch, kernel_size, 1,
                              (kernel_size - 1) // 2)
        self.actv2 = _Actv(actv2, out_ch) if actv2 else None
        self.shortcut_up = up(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c1_conv(self.actv1(self.c1_up(x)))
        if self.actv2 is not None:
            y = self.actv2(y)
        return y + self.shortcut_up(x)

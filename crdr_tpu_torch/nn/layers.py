"""ELIC building blocks and Cheng attention (NCHW), with the reference's
module names so ``state_dict`` keys are the reference's own.

Counterpart of ``crdr_tpu/nn/layers.py``; architecture contracts:
* ``BaseBlock`` / ``ResidualBottleneckBlocks``: elic_layers.py:23-53
* ``up_conv``: elic_layers.py:14-21 (ConvTranspose k5 s2 p2 op1, or a k5
  conv to 4x the channels + PixelShuffle(2))
* ``ChengNLAM`` / ``NLAMResBlock``: cheng_nlam.py:5-47
* ``BetaCondBaseBlock`` / ``BetaCondResidualBottleneckBlocks``:
  elic_interpca_beta_cond_autoencoder.py:42-85
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv2d, ConvTranspose2d


class BaseBlock(nn.Module):
    """1x1 -> ReLU -> 3x3 -> ReLU -> 1x1 with residual add."""

    def __init__(self, ch: int, mid_ch: int, w_init: str = "torch"):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(ch, mid_ch, 1, 1, 0, w_init=w_init), nn.ReLU(),
            Conv2d(mid_ch, mid_ch, 3, 1, 1, w_init=w_init), nn.ReLU(),
            Conv2d(mid_ch, ch, 1, 1, 0, w_init=w_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class ResidualBottleneckBlocks(nn.Module):
    def __init__(self, ch: int, mid_ch: int, num_blocks: int = 3,
                 res_in_res: bool = False, w_init: str = "torch"):
        super().__init__()
        self.num_blocks, self.res_in_res = num_blocks, res_in_res
        for i in range(num_blocks):
            setattr(self, f"block{i}", BaseBlock(ch, mid_ch, w_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.num_blocks):
            y = getattr(self, f"block{i}")(y)
        return x + y if self.res_in_res else y


class PixelShuffleUpConv(Conv2d):
    """2x upsampler: a k5 stride-1 conv to ``4 * out_ch`` channels, then
    ``pixel_shuffle(2)`` (torch's channel order, as the JAX package's
    ``nn/conv.py::pixel_shuffle`` reproduces it)."""

    def __init__(self, in_ch: int, out_ch: int, w_init: str = "torch"):
        super().__init__(in_ch, 4 * out_ch, 5, 1, 2, w_init=w_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(super().forward(x), 2)


def up_conv(in_ch: int, out_ch: int, pixel_shuffle: bool = False,
            w_init: str = "torch") -> nn.Module:
    """2x upsampler: ConvTranspose(k5, s2, p2, op1), or the pixel-shuffle
    conv.  Either way the parameters are the module's own ``weight`` and
    ``bias`` (reference name ``decoder.convN.weight``)."""
    if pixel_shuffle:
        return PixelShuffleUpConv(in_ch, out_ch, w_init=w_init)
    return ConvTranspose2d(in_ch, out_ch, 5, 2, 2, 1, w_init=w_init)


class NLAMResBlock(nn.Module):
    """Half-width bottleneck residual block used inside ChengNLAM."""

    def __init__(self, ch: int, w_init: str = "torch"):
        super().__init__()
        mid = ch // 2
        self.c1 = Conv2d(ch, mid, 1, 1, 0, w_init=w_init)
        self.c2 = Conv2d(mid, mid, 3, 1, 1, w_init=w_init)
        self.c3 = Conv2d(mid, ch, 1, 1, 0, w_init=w_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.c1(x))
        y = torch.relu(self.c2(y))
        return x + self.c3(y)


class ChengNLAM(nn.Module):
    """Cheng CVPR2020 simplified attention: x + trunk(x) * sigmoid(conv(attn(x)))."""

    def __init__(self, ch: int, w_init: str = "torch"):
        super().__init__()
        self.trunk_block = nn.Sequential(
            *[NLAMResBlock(ch, w_init) for _ in range(3)])
        self.attention_block = nn.Sequential(
            *[NLAMResBlock(ch, w_init) for _ in range(3)])
        self.conv = Conv2d(ch, ch, 1, 1, 0, w_init=w_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trunk = self.trunk_block(x)
        attn = self.conv(self.attention_block(x))
        return x + trunk * torch.sigmoid(attn)


class BetaCondBaseBlock(nn.Module):
    """BaseBlock with per-conv additive projections of the beta condition
    feature ``cond`` [N or 1, cond_ch, 1, 1]."""

    def __init__(self, ch: int, mid_ch: int, cond_ch: int,
                 w_init: str = "torch"):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(ch, mid_ch, 1, 1, 0, w_init=w_init), nn.ReLU(),
            Conv2d(mid_ch, mid_ch, 3, 1, 1, w_init=w_init), nn.ReLU(),
            Conv2d(mid_ch, ch, 1, 1, 0, w_init=w_init))
        self.proj_1 = Conv2d(cond_ch, mid_ch, 1, 1, 0, w_init=w_init)
        self.proj_2 = Conv2d(cond_ch, mid_ch, 1, 1, 0, w_init=w_init)
        self.proj_3 = Conv2d(cond_ch, ch, 1, 1, 0, w_init=w_init)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.conv[0](x))
        y = y + self.proj_1(cond)
        y = torch.relu(self.conv[2](y))
        y = y + self.proj_2(cond)
        y = self.conv[4](y)
        y = y + self.proj_3(cond)
        return y + x


class BetaCondResidualBottleneckBlocks(nn.Module):
    def __init__(self, ch: int, mid_ch: int, cond_ch: int, num_blocks: int = 3,
                 res_in_res: bool = False, w_init: str = "torch"):
        super().__init__()
        self.num_blocks, self.res_in_res = num_blocks, res_in_res
        for i in range(num_blocks):
            setattr(self, f"block{i}",
                    BetaCondBaseBlock(ch, mid_ch, cond_ch, w_init))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.num_blocks):
            y = getattr(self, f"block{i}")(y, cond)
        return x + y if self.res_in_res else y

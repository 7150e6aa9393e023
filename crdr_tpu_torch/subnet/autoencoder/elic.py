"""ELIC analysis / synthesis transforms (He et al., CVPR 2022), NCHW.

Counterpart of ``crdr_tpu/subnet/autoencoder/elic.py`` (reference
elic_autoencoder.py:31-119): 4 stride-2 k5 convs with residual-bottleneck
stacks and ChengNLAM after stages 2 and 4 (encoder); mirrored up-convs, with
ChengNLAM before the first and after the second (decoder).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import ChengNLAM, Conv2d, ResidualBottleneckBlocks, up_conv
from ...utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY


@ENCODER_REGISTRY.register()
class ElicEncoder(nn.Module):
    layer_names = ("conv1", "block1", "conv2", "block2", "attn2", "conv3",
                   "block3", "conv4", "attn4")

    def __init__(self, in_ch: int = 3, out_ch: int = 192, main_ch: int = 192,
                 block_mid_ch: int = 192, num_blocks: int = 3,
                 res_in_res: bool = False):
        super().__init__()
        m, mid = main_ch, block_mid_ch
        self.conv1 = Conv2d(in_ch, m, 5, 2, 2)
        self.block1 = ResidualBottleneckBlocks(m, mid, num_blocks, res_in_res)
        self.conv2 = Conv2d(m, m, 5, 2, 2)
        self.block2 = ResidualBottleneckBlocks(m, mid, num_blocks, res_in_res)
        self.attn2 = ChengNLAM(m)
        self.conv3 = Conv2d(m, m, 5, 2, 2)
        self.block3 = ResidualBottleneckBlocks(m, mid, num_blocks, res_in_res)
        self.conv4 = Conv2d(m, out_ch, 5, 2, 2)
        self.attn4 = ChengNLAM(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return x


@DECODER_REGISTRY.register()
class ElicDecoder(nn.Module):
    layer_names = ("attn1", "conv1", "block1", "conv2", "attn2", "block2",
                   "conv3", "block3", "conv4")

    def __init__(self, in_ch: int = 192, out_ch: int = 3, main_ch: int = 192,
                 block_mid_ch: int = 192, num_blocks: int = 3,
                 use_tanh: bool = True, pixel_shuffle: bool = False,
                 res_in_res: bool = False):
        super().__init__()
        m, mid, ps = main_ch, block_mid_ch, pixel_shuffle
        self.use_tanh = use_tanh
        self.attn1 = ChengNLAM(in_ch)
        self.conv1 = up_conv(in_ch, m, ps)
        self.block1 = ResidualBottleneckBlocks(m, mid, num_blocks, res_in_res)
        self.conv2 = up_conv(m, m, ps)
        self.attn2 = ChengNLAM(m)
        self.block2 = ResidualBottleneckBlocks(m, mid, num_blocks, res_in_res)
        self.conv3 = up_conv(m, m, ps)
        self.block3 = ResidualBottleneckBlocks(m, mid, num_blocks, res_in_res)
        self.conv4 = up_conv(m, out_ch, ps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return torch.tanh(x) if self.use_tanh else x

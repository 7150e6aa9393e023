"""Balle et al. 2018 hyperprior autoencoder (reference
balle18_autoencoder.py:11-51; counterpart of
``crdr_tpu/subnet/autoencoder/balle18.py``), NCHW.

Four 5x5 stride-2 convolutions with GDN between them (analysis), four 5x5
stride-2 transposed convolutions with inverse GDN (synthesis).  Submodules
carry the flax names (``conv_0``, ``gdn_1``, ...), so the exporter maps them
one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import GDN, Conv2d, ConvTranspose2d
from ...utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY


@ENCODER_REGISTRY.register()
class Balle18Encoder(nn.Module):
    def __init__(self, in_ch: int = 3, out_ch: int = 192, main_ch: int = 192):
        super().__init__()
        m = main_ch
        self.conv_0 = Conv2d(in_ch, m, 5, 2, 2)
        self.gdn_1 = GDN(m)
        self.conv_2 = Conv2d(m, m, 5, 2, 2)
        self.gdn_3 = GDN(m)
        self.conv_4 = Conv2d(m, m, 5, 2, 2)
        self.gdn_5 = GDN(m)
        self.conv_6 = Conv2d(m, out_ch, 5, 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


@DECODER_REGISTRY.register()
class Balle18Decoder(nn.Module):
    def __init__(self, in_ch: int = 192, out_ch: int = 3, main_ch: int = 192,
                 use_tanh: bool = True):
        super().__init__()
        m = main_ch
        self.use_tanh = use_tanh
        self.conv_0 = ConvTranspose2d(in_ch, m, 5, 2, 2, 1)
        self.igdn_1 = GDN(m, inverse=True)
        self.conv_2 = ConvTranspose2d(m, m, 5, 2, 2, 1)
        self.igdn_3 = GDN(m, inverse=True)
        self.conv_4 = ConvTranspose2d(m, m, 5, 2, 2, 1)
        self.igdn_5 = GDN(m, inverse=True)
        self.conv_6 = ConvTranspose2d(m, out_ch, 5, 2, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return torch.tanh(x) if self.use_tanh else x

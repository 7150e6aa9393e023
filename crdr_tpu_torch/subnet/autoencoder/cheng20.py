"""Cheng et al. 2020 autoencoder family and its InterpCA variants
(reference cheng20_autoencoder.py:13-106, cheng20_interpca_autoencoder.py:
17-74; counterpart of ``crdr_tpu/subnet/autoencoder/cheng20.py``), NCHW.

GDN / IGDN residual blocks (``nn/resblock.py``: three GDN in the analysis,
three IGDN in the synthesis, each K3 on the card), ChengNLAM after stages,
pixel-shuffle upsampling.  Unlike the ELIC InterpCA nets, the JAX package
holds the Cheng20 layers directly (no ``body``); the InterpChAtt layers are
``interp_ca_list.N`` here and ``interp_ca_N`` there.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import ChengNLAM, Conv2d, InterpChAtt
from ...nn.resblock import ResBlock, UpResBlock
from ...utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY


@ENCODER_REGISTRY.register()
class Cheng20Encoder(nn.Module):
    layer_names = ("block1", "block2", "block3", "nlam1", "block4", "block5",
                   "block6", "conv7", "nlam2")

    def __init__(self, in_ch: int = 3, out_ch: int = 192, main_ch: int = 192):
        super().__init__()
        m = main_ch
        down = dict(actv="lrelu", actv2="gdn", downscale=True)
        normal = dict(actv="lrelu", actv2="lrelu", downscale=False)
        self.block1 = ResBlock(in_ch, m, **down)
        self.block2 = ResBlock(m, m, **normal)
        self.block3 = ResBlock(m, m, **down)
        self.nlam1 = ChengNLAM(m)
        self.block4 = ResBlock(m, m, **normal)
        self.block5 = ResBlock(m, m, **down)
        self.block6 = ResBlock(m, m, **normal)
        self.conv7 = Conv2d(m, out_ch, 3, 2, 1)
        self.nlam2 = ChengNLAM(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return x


@DECODER_REGISTRY.register()
class Cheng20Decoder(nn.Module):
    layer_names = ("nlam0", "block0", "up0", "block1", "up1", "nlam2",
                   "block2", "up2", "block3", "up3")

    def __init__(self, in_ch: int = 192, out_ch: int = 3, main_ch: int = 192,
                 use_tanh: bool = True):
        super().__init__()
        m = main_ch
        self.use_tanh = use_tanh
        up = dict(actv="lrelu", actv2="igdn")
        normal = dict(actv="lrelu", actv2="lrelu")
        self.nlam0 = ChengNLAM(in_ch)
        self.block0 = ResBlock(in_ch, m, **normal)
        self.up0 = UpResBlock(m, m, **up)
        self.block1 = ResBlock(m, m, **normal)
        self.up1 = UpResBlock(m, m, **up)
        self.nlam2 = ChengNLAM(m)
        self.block2 = ResBlock(m, m, **normal)
        self.up2 = UpResBlock(m, m, **up)
        self.block3 = ResBlock(m, m, **normal)
        self.up3_conv = Conv2d(m, out_ch * 4, 3, 1, 1)

    def _layer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name == "up3":
            return F.pixel_shuffle(self.up3_conv(x), 2)
        return getattr(self, name)(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.layer_names:
            x = self._layer(name, x)
        return torch.tanh(x) if self.use_tanh else x


@ENCODER_REGISTRY.register()
class Cheng20InterpCaEncoder(Cheng20Encoder):
    def __init__(self, rate_level: int = 5, in_ch: int = 3, out_ch: int = 192,
                 main_ch: int = 192, ca_kwargs: Dict = None):
        super().__init__(in_ch, out_ch, main_ch)
        chs = [out_ch if n in ("conv7", "nlam2") else main_ch
               for n in self.layer_names]
        self.interp_ca_list = nn.ModuleList(
            InterpChAtt(ch, rate_level, **dict(ca_kwargs or {})) for ch in chs)

    def forward(self, x: torch.Tensor, rate_ind: torch.Tensor) -> torch.Tensor:
        for name, ca in zip(self.layer_names, self.interp_ca_list):
            x = ca(getattr(self, name)(x), rate_ind)
        return x


@DECODER_REGISTRY.register()
class Cheng20InterpCaDecoder(Cheng20Decoder):
    def __init__(self, rate_level: int = 5, in_ch: int = 192, out_ch: int = 3,
                 main_ch: int = 192, use_tanh: bool = True,
                 ca_kwargs: Dict = None):
        super().__init__(in_ch, out_ch, main_ch, use_tanh)
        chs = [in_ch if i < 2 else main_ch
               for i in range(len(self.layer_names))]
        self.interp_ca_list = nn.ModuleList(
            InterpChAtt(ch, rate_level, **dict(ca_kwargs or {})) for ch in chs)

    def forward(self, x: torch.Tensor, rate_ind: torch.Tensor) -> torch.Tensor:
        for name, ca in zip(self.layer_names, self.interp_ca_list):
            x = self._layer(name, ca(x, rate_ind))
        return torch.tanh(x) if self.use_tanh else x

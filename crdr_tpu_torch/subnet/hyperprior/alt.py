"""Balle18 hyper-encoder / hyper-decoder (reference balle18_hyperprior.py:9-45;
counterpart of the Balle18 pair in ``crdr_tpu/subnet/hyperprior/alt.py``),
NCHW.  The hyper-decoder emits [mean || scale] on ``out_ch`` channels.  The
Cheng20 pair is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import Conv2d, ConvTranspose2d
from ...utils.registry import HYPERDECODER_REGISTRY, HYPERENCODER_REGISTRY


@HYPERENCODER_REGISTRY.register()
class Balle18HyperEncoder(nn.Module):
    def __init__(self, in_ch: int = 192, out_ch: int = 192,
                 main_ch: int = 192):
        super().__init__()
        self.c1 = Conv2d(in_ch, main_ch, 3, 1, 1)
        self.c2 = Conv2d(main_ch, main_ch, 5, 2, 2)
        self.c3 = Conv2d(main_ch, out_ch, 5, 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.c1(x))
        x = torch.relu(self.c2(x))
        return self.c3(x)


@HYPERDECODER_REGISTRY.register()
class Balle18HyperDecoder(nn.Module):
    def __init__(self, in_ch: int = 192, out_ch: int = 384,
                 main_ch: int = 192):
        super().__init__()
        self.c1 = ConvTranspose2d(in_ch, main_ch, 5, 2, 2, 1)
        self.c2 = ConvTranspose2d(main_ch, main_ch, 5, 2, 2, 1)
        self.c3 = Conv2d(main_ch, out_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.c1(x))
        x = torch.relu(self.c2(x))
        return self.c3(x)

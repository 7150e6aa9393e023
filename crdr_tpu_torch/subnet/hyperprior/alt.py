"""Alternative hyper-encoders / hyper-decoders: the Balle18 and Cheng20
pairs (reference balle18_hyperprior.py:9-45, cheng20_hyperprior.py:23-59;
counterpart of ``crdr_tpu/subnet/hyperprior/alt.py``), NCHW.  Each
hyper-decoder emits [mean || scale] on ``out_ch`` channels.

In the Cheng20 hyper-decoder, ``c2`` and ``c4`` are transposed convs and
``c1`` / ``c3`` / ``c5`` plain ones.  The JAX package's importer takes
``hyperdecoder.c1`` / ``c2`` as transposed by name (the Balle18 rule), so it
cannot load this pair; weights go JAX -> port through
``importers/jax_params.py::export_state_dict``, which picks the layout by
module type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
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


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


@HYPERENCODER_REGISTRY.register()
class Cheng20HyperEncoder(nn.Module):
    def __init__(self, in_ch: int = 192, out_ch: int = 192,
                 main_ch: int = 192):
        super().__init__()
        m = main_ch
        self.c1 = Conv2d(in_ch, m, 3, 1, 1)
        self.c2 = Conv2d(m, m, 3, 1, 1)
        self.c3 = Conv2d(m, m, 3, 2, 1)
        self.c4 = Conv2d(m, m, 3, 1, 1)
        self.c5 = Conv2d(m, out_ch, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.c1, self.c2, self.c3, self.c4):
            x = _lrelu(conv(x))
        return self.c5(x)


@HYPERDECODER_REGISTRY.register()
class Cheng20HyperDecoder(nn.Module):
    def __init__(self, in_ch: int = 192, out_ch: int = 384,
                 main_ch: int = 192):
        super().__init__()
        m = main_ch
        self.c1 = Conv2d(in_ch, m, 3, 1, 1)
        self.c2 = ConvTranspose2d(m, m, 4, 2, 1, 0)
        self.c3 = Conv2d(m, m, 3, 1, 1)
        self.c4 = ConvTranspose2d(m, m, 4, 2, 1, 0)
        self.c5 = Conv2d(m, out_ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.c1, self.c2, self.c3, self.c4):
            x = _lrelu(conv(x))
        return self.c5(x)

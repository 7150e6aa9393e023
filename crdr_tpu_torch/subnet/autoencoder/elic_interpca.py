"""ELIC + InterpCA variable-rate analysis and synthesis transforms.

Counterpart of ``crdr_tpu/subnet/autoencoder/elic_interpca.py`` (reference
elic_interpca_autoencoder.py:22-97): an InterpChAtt after each of the
encoder's 9 named layers, and before each of the decoder's 9 layers.  As in
the reference, the ELIC layers are the module's own (subclassing), so their
names carry no ``body`` prefix (the JAX package nests them under ``body``;
the exporter maps the two).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...nn import InterpChAtt
from ...utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY
from .elic import ElicDecoder, ElicEncoder


@ENCODER_REGISTRY.register()
class ElicInterpCaEncoder(ElicEncoder):
    def __init__(self, rate_level: int = 5, in_ch: int = 3, out_ch: int = 192,
                 main_ch: int = 192, block_mid_ch: int = 192,
                 num_blocks: int = 3, ca_kwargs: Dict = None):
        super().__init__(in_ch, out_ch, main_ch, block_mid_ch, num_blocks)
        chs = [main_ch] * 7 + [out_ch] * 2
        self.interp_ca_list = nn.ModuleList(
            InterpChAtt(ch, rate_level, **dict(ca_kwargs or {})) for ch in chs)

    def forward(self, x: torch.Tensor, rate_ind: torch.Tensor) -> torch.Tensor:
        for name, ca in zip(self.layer_names, self.interp_ca_list):
            x = ca(getattr(self, name)(x), rate_ind)
        return x


@DECODER_REGISTRY.register()
class ElicInterpCaDecoder(ElicDecoder):
    def __init__(self, rate_level: int = 5, in_ch: int = 192, out_ch: int = 3,
                 main_ch: int = 192, block_mid_ch: int = 192,
                 num_blocks: int = 3, use_tanh: bool = True,
                 pixel_shuffle: bool = False, ca_kwargs: Dict = None):
        super().__init__(in_ch, out_ch, main_ch, block_mid_ch, num_blocks,
                         use_tanh, pixel_shuffle)
        chs = [in_ch] * 2 + [main_ch] * 7
        self.interp_ca_list = nn.ModuleList(
            InterpChAtt(ch, rate_level, **dict(ca_kwargs or {})) for ch in chs)

    def forward(self, x: torch.Tensor, rate_ind: torch.Tensor) -> torch.Tensor:
        for name, ca in zip(self.layer_names, self.interp_ca_list):
            x = getattr(self, name)(ca(x, rate_ind))
        return torch.tanh(x) if self.use_tanh else x

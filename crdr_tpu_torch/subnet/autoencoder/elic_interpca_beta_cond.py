"""Stage-3 synthesis transform: ELIC + InterpCA + Fourier beta conditioning.

Counterpart of ``crdr_tpu/subnet/autoencoder/elic_interpca_beta_cond.py``
(reference elic_interpca_beta_cond_autoencoder.py:87-163): the ELIC decoder
skeleton whose three residual stacks are beta-conditioned; beta -> Fourier
embedding -> 2-layer MLP -> [N, cond_ch, 1, 1] feature added via 1x1
projections inside each block.  With ``weight_init: True`` every conv and
dense weight gets DCGAN N(0, 0.02) init (dense biases zero).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...nn import (BetaCondResidualBottleneckBlocks, ChengNLAM, Dense,
                   InterpChAtt, fourier_embed, up_conv)
from ...utils.registry import DECODER_REGISTRY


@DECODER_REGISTRY.register()
class ElicInterpCaBetaCondDecoder(nn.Module):
    layer_names = ("attn1", "conv1", "block1", "conv2", "attn2", "block2",
                   "conv3", "block3", "conv4")

    def __init__(self, rate_level: int = 5, L: int = 10, max_beta: float = 5.12,
                 cond_ch: int = 512, use_pi: bool = True,
                 include_x: bool = False, weight_init: bool = False,
                 in_ch: int = 192, out_ch: int = 3, main_ch: int = 192,
                 block_mid_ch: int = 192, num_blocks: int = 3,
                 use_tanh: bool = True, pixel_shuffle: bool = False,
                 res_in_res: bool = False, ca_kwargs: Dict = None):
        super().__init__()
        self.L, self.max_beta = L, max_beta
        self.use_pi, self.include_x, self.use_tanh = use_pi, include_x, use_tanh
        wi = "dcgan" if weight_init else "torch"
        m, mid, cch = main_ch, block_mid_ch, cond_ch

        self.attn1 = ChengNLAM(in_ch, w_init=wi)
        self.conv1 = up_conv(in_ch, m, pixel_shuffle, wi)
        self.block1 = BetaCondResidualBottleneckBlocks(
            m, mid, cch, num_blocks, res_in_res, w_init=wi)
        self.conv2 = up_conv(m, m, pixel_shuffle, wi)
        self.attn2 = ChengNLAM(m, w_init=wi)
        self.block2 = BetaCondResidualBottleneckBlocks(
            m, mid, cch, num_blocks, res_in_res, w_init=wi)
        self.conv3 = up_conv(m, m, pixel_shuffle, wi)
        self.block3 = BetaCondResidualBottleneckBlocks(
            m, mid, cch, num_blocks, res_in_res, w_init=wi)
        self.conv4 = up_conv(m, out_ch, pixel_shuffle, wi)

        chs = [in_ch] * 2 + [m] * 7
        self.interp_ca_list = nn.ModuleList(
            InterpChAtt(ch, rate_level, **dict(ca_kwargs or {})) for ch in chs)
        bi = "zeros" if weight_init else "torch"
        emb = 2 * L + (1 if include_x else 0)
        self.mlp = nn.Sequential(Dense(emb, cch, w_init=wi, b_init=bi),
                                 nn.ReLU(),
                                 Dense(cch, cch, w_init=wi, b_init=bi))

    def cond_feature(self, beta: torch.Tensor) -> torch.Tensor:
        emb = fourier_embed(beta, self.L, self.max_beta, self.use_pi,
                            self.include_x)  # [N, 2L], f32
        return self.mlp(emb)[:, :, None, None]  # [N, cond_ch, 1, 1]

    def forward(self, x: torch.Tensor, rate_ind: torch.Tensor,
                beta: torch.Tensor) -> torch.Tensor:
        cond = self.cond_feature(beta)
        for name, ca in zip(self.layer_names, self.interp_ca_list):
            x = ca(x, rate_ind)
            layer = getattr(self, name)
            x = layer(x, cond) if name.startswith("block") else layer(x)
        return torch.tanh(x) if self.use_tanh else x

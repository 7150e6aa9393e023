"""HiFiC encoder / generator (Mentzer et al. 2020; reference
hific_autoencoder.py:22-300; counterpart of
``crdr_tpu/subnet/autoencoder/hific.py``), NCHW.

A 7x7 reflect-padded stem, four stride-2 convs with ChannelNorm; the
decoder: 9 residual blocks, 4 transposed convs (or pixel-shuffle convs),
optional noise channels, a 7x7 output conv.  The norms are ``nn/norm.py``'s
``ChannelNorm2D`` / ``InstanceNorm2D`` under ``<name>.norm``, as the flax
tree nests them.  The codec never samples noise (``models/net.py`` calls
the decoder with the latent only, as the JAX package's ``CompNet`` does);
``sample_noise`` draws it from a ``torch.Generator``, or takes it as given.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import ChannelNorm2D, Conv2d, ConvTranspose2d, InstanceNorm2D
from ...utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY

_ACTV = {"relu": torch.relu, "elu": F.elu,
         "leaky_relu": lambda x: F.leaky_relu(x, 0.01)}


def _reflect(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    # F.pad orders the last axis first: (left, right, top, bottom)
    return F.pad(x, (left, right, top, bottom), mode="reflect")


class _Norm(nn.Module):
    def __init__(self, ch: int, use_norm: bool = True,
                 channel_norm: bool = True):
        super().__init__()
        if use_norm:
            self.norm = ChannelNorm2D(ch) if channel_norm \
                else InstanceNorm2D(ch)
        else:
            self.norm = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.norm is None else self.norm(x)


@ENCODER_REGISTRY.register()
class HificEncoder(nn.Module):
    def __init__(self, in_ch: int = 3, bottleneck_y: int = 220,
                 filters: Sequence[int] = (60, 120, 240, 480, 960),
                 activation: str = "relu", use_norm: bool = True,
                 channel_norm: bool = True):
        super().__init__()
        f = list(filters)
        self.act = _ACTV[activation]
        self.conv_block1 = Conv2d(in_ch, f[0], 7, 1, 0)
        self.norm1 = _Norm(f[0], use_norm, channel_norm)
        for i in range(4):
            setattr(self, f"conv_block{i + 2}", Conv2d(f[i], f[i + 1], 3, 2, 0))
            setattr(self, f"norm{i + 2}", _Norm(f[i + 1], use_norm,
                                                channel_norm))
        self.conv_block_out = Conv2d(f[4], bottleneck_y, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.norm1(self.conv_block1(_reflect(x, 3, 3, 3, 3))))
        # four stride-2 convs, each after a reflect pad of the top and right
        for i in range(2, 6):
            x = getattr(self, f"conv_block{i}")(_reflect(x, 1, 0, 0, 1))
            x = self.act(getattr(self, f"norm{i}")(x))
        return self.conv_block_out(_reflect(x, 1, 1, 1, 1))


class HificResidualBlock(nn.Module):
    def __init__(self, ch: int, activation: str = "relu",
                 use_norm: bool = True, channel_norm: bool = True):
        super().__init__()
        self.act = _ACTV[activation]
        self.conv1 = Conv2d(ch, ch, 3, 1, 0)
        self.norm1 = _Norm(ch, use_norm, channel_norm)
        self.conv2 = Conv2d(ch, ch, 3, 1, 0)
        self.norm2 = _Norm(ch, use_norm, channel_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.act(self.norm1(self.conv1(_reflect(x, 1, 1, 1, 1))))
        res = self.norm2(self.conv2(_reflect(res, 1, 1, 1, 1)))
        return x + res


class _UpLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 use_pixelshuffle: bool = False):
        super().__init__()
        if use_pixelshuffle:
            self.conv = Conv2d(in_ch, out_ch * 4, 3, 1, 1)
        else:
            self.deconv = ConvTranspose2d(in_ch, out_ch, 3, 2, 1, 1)
        self.use_pixelshuffle = use_pixelshuffle

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_pixelshuffle:
            return F.pixel_shuffle(self.conv(x), 2)
        return self.deconv(x)


@DECODER_REGISTRY.register()
class HificDecoder(nn.Module):
    def __init__(self, bottleneck_y: int = 220, activation: str = "relu",
                 n_residual_blocks: int = 9,
                 filters: Sequence[int] = (960, 480, 240, 120, 60),
                 use_norm: bool = True, channel_norm: bool = True,
                 use_first_norm: bool = True, sample_noise: bool = False,
                 use_tanh: bool = True, use_pixelshuffle: bool = False,
                 noise_dim: int = 32):
        super().__init__()
        f = list(filters)
        self.act = _ACTV[activation]
        self.n_residual_blocks = n_residual_blocks
        self.sample_noise, self.noise_dim = sample_noise, noise_dim
        self.use_tanh = use_tanh
        self.first_norm = _Norm(bottleneck_y, use_norm and use_first_norm,
                                channel_norm)
        self.conv_block_init = Conv2d(bottleneck_y, f[0], 3, 1, 0)
        self.init_norm = _Norm(f[0], use_norm, channel_norm)
        width = f[0] + (noise_dim if sample_noise else 0)
        for m in range(n_residual_blocks):
            setattr(self, f"resblock_{m}", HificResidualBlock(
                width, activation, use_norm, channel_norm))
        for i in range(4):
            setattr(self, f"upconv_block{i + 1}", _UpLayer(
                width if i == 0 else f[i], f[i + 1], use_pixelshuffle))
            setattr(self, f"up_norm{i + 1}", _Norm(f[i + 1], use_norm,
                                                   channel_norm))
        self.conv_block_out = Conv2d(f[4], 3, 7, 1, 0)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise`` [N, noise_dim, H, W] is used as given; else, with
        ``sample_noise``, it is drawn from ``generator``."""
        x = self.conv_block_init(_reflect(self.first_norm(x), 1, 1, 1, 1))
        head = self.init_norm(x)
        if self.sample_noise:
            if noise is None:
                if generator is None:
                    raise ValueError("a sample_noise decoder needs a "
                                     "generator or the noise")
                n, _, h, w = head.shape
                noise = torch.randn((n, self.noise_dim, h, w),
                                    generator=generator, dtype=head.dtype,
                                    device=head.device)
            head = torch.cat([head, noise.to(head.dtype)], dim=1)
        y = head
        for m in range(self.n_residual_blocks):
            y = getattr(self, f"resblock_{m}")(y)
        y = y + head
        for i in range(1, 5):
            y = getattr(self, f"upconv_block{i}")(y)
            y = self.act(getattr(self, f"up_norm{i}")(y))
        y = self.conv_block_out(_reflect(y, 3, 3, 3, 3))
        return torch.tanh(y) if self.use_tanh else y

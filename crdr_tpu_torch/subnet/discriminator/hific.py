"""HiFiC spectral-norm patch discriminators (NCHW; counterpart of
``crdr_tpu/subnet/discriminator/hific.py``, reference
hific_discriminator.py:24-57).

The spectral norm is flax's ``nn.SpectralNorm`` (one power step), not
``torch.nn.utils.spectral_norm``.  flax reshapes the HWIO kernel to
(kh*kw*in, out), so ``u`` has one entry per output channel and starts from
a normal draw; here the OIHW weight is reshaped to (out, in*kh*kw), which
permutes the rows flax iterates over and leaves ``u`` and sigma as they
are.  A call takes one step with flax's ``_l2_normalize``,
``x * rsqrt(sum(x^2) + 1e-12)``::

    v = l2n(u W),  u' = l2n(v W^T),  sigma = v W u'^T   (u, v detached)

and convolves with ``W / sigma`` (``W`` where sigma is 0); the bias is not
normalized.  ``u`` and ``sigma`` are buffers, stored whenever
``update_stats`` is set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Conv2d
from ...utils.registry import DISCRIMINATOR_REGISTRY
from .clic21 import Discriminator

SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + SN_EPS)


class SNConv(nn.Module):
    """``_SNConv``: a conv whose weight is spectrally normalized (with
    ``use_sn``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, use_sn: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride, padding)
        self.use_sn = use_sn
        if use_sn:
            self.register_buffer("u", torch.empty(1, out_ch))
            self.register_buffer("sigma", torch.ones(()))

    def reset_parameters(self, generator=None) -> None:
        if self.use_sn:
            with torch.no_grad():
                self.u.normal_(generator=generator)
                self.sigma.fill_(1.0)

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.conv.weight
        mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat)
            u = _l2_normalize(v @ mat.t())
        sigma = (v @ mat.t() @ u.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        if not self.use_sn:
            return self.conv(x)
        w = self.normalized_weight(update_stats)
        b = self.conv.bias
        return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                        self.conv.stride, self.conv.padding)


@DISCRIMINATOR_REGISTRY.register()
class HiFiCDiscriminator(Discriminator):
    def __init__(self, in_ch: int = 3, out_ch: int = 1, main_ch: int = 64,
                 use_sn: bool = True, cond: bool = False):
        super().__init__()
        m = main_ch
        specs = [(in_ch, m, 4, 2, 2), (m, m * 2, 4, 2, 2),
                 (m * 2, m * 4, 4, 2, 2), (m * 4, m * 8, 4, 1, 2),
                 (m * 8, out_ch, 1, 1, 0)]
        for i, (ci, co, k, s, p) in enumerate(specs):
            self.add_module(f"layer_{i}", SNConv(ci, co, k, s, p, use_sn))

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        for i in range(4):
            x = F.leaky_relu(self._modules[f"layer_{i}"](x, update_stats),
                             0.2)
        return self.layer_4(x, update_stats)


@DISCRIMINATOR_REGISTRY.register()
class HiFiCConditionalDiscriminator(Discriminator):
    """Conditions on y_hat (detached): 1x1 conv -> leaky ReLU -> x16 nearest
    upsample -> concatenated after the image."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1, main_ch: int = 64,
                 y_ch: int = 192, latent_nc: int = 12, use_sn: bool = True,
                 cond: bool = False):
        super().__init__()
        self.latent_conv = Conv2d(y_ch, latent_nc, 1, 1, 0)
        self.model = HiFiCDiscriminator(in_ch + latent_nc, out_ch, main_ch,
                                        use_sn)

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        if y_hat is None:
            raise ValueError("a latent-conditional discriminator needs y_hat")
        cond = F.leaky_relu(self.latent_conv(y_hat.detach()), 0.2)
        h, w = cond.shape[2:]
        cond = F.interpolate(cond, size=(h * 16, w * 16), mode="nearest")
        return self.model(torch.cat([x, cond], dim=1),
                          update_stats=update_stats)

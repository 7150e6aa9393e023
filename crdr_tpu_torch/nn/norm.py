"""Normalization layers (NCHW): GDN, ChannelNorm2D, InstanceNorm2D and
flax's BatchNorm.

Counterpart of ``crdr_tpu/nn/norm.py``.  GDN follows CompressAI's
formulation: ``y = x * (beta + gamma . x^2)^(-1/2)``, or ``^(+1/2)`` for
the inverse, with non-negative reparameterized ``beta`` /
``gamma`` stored as ``sqrt(value + pedestal)``.  ``state_dict`` holds
exactly ``beta`` [C] and ``gamma`` [C_out, C_in]; the pedestal and the bound
are constants.  The forward is K3 (``ops/gdn.py``) on the card, its plain
twin on the CPU, in the parameters' dtype: the codec's bf16 copies of the
transforms (``transform_dtype: bfloat16``) reparameterize and run GDN in
bf16, as the JAX package does.

``ChannelNorm2D`` (HiFiC: moments over the channels, unbiased variance, eps
1e-3) and ``InstanceNorm2D`` (moments over the pixels, biased variance, eps
1e-5) carry ``gamma`` / ``beta``.  ``InstanceNorm2D`` takes its moments
through ``parallel/spatial.py::image_moments``: ``torch.mean`` /
``torch.var`` over the pixels, or, in a tile of a spatial split, the whole
image's from the tiles' exchange.  ``BatchNorm2D`` is flax's
``nn.BatchNorm`` (momentum 0.9, eps 1e-5), not ``torch.nn.BatchNorm2d``: in
training it normalizes with the batch's moments computed in f32 as E[x],
E[x^2] - E[x]^2, and its running ``var`` takes the *biased* batch variance,
``var <- 0.9 var + 0.1 batch_var``; its parameters are ``scale`` / ``bias``
and its buffers ``mean`` / ``var``, flax's names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..entropy.ops import lower_bound
from ..ops.gdn import gdn
from ..parallel.spatial import image_moments

_REPARAM_OFFSET = 2.0 ** -18


class NonNegativeParam:
    """CompressAI NonNegativeParametrizer: store sqrt(x + pedestal), recover
    lower_bound(stored)^2 - pedestal."""

    def __init__(self, minimum: float = 0.0):
        self.pedestal = _REPARAM_OFFSET ** 2
        self.bound = (minimum + _REPARAM_OFFSET ** 2) ** 0.5
        self._bounds = {}  # dtype -> the bound in it, as JAX converts it

    def init(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.clamp(x + self.pedestal, min=self.pedestal))

    def __call__(self, stored: torch.Tensor) -> torch.Tensor:
        bound = self._bounds.get(stored.dtype)
        if bound is None:  # once a dtype, not on every forward
            bound = self._bounds[stored.dtype] = torch.tensor(
                self.bound, dtype=stored.dtype).item()
        # in bf16 the square and the pedestal's subtraction round to bf16
        # each, as JAX's do
        return lower_bound(stored, bound) ** 2 - self.pedestal


class GDN(nn.Module):
    """Generalized divisive normalization; ``inverse`` gives IGDN."""

    def __init__(self, ch: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.gamma_init = gamma_init
        self._beta_rp = NonNegativeParam(beta_min)
        self._gamma_rp = NonNegativeParam()
        self.beta = nn.Parameter(torch.empty(ch))
        self.gamma = nn.Parameter(torch.empty(ch, ch))

    def reset_parameters(self, generator=None) -> None:
        """Deterministic (``generator`` is not drawn from): beta = 1 and
        gamma = gamma_init * I, reparameterized, as ``norm.py`` initializes."""
        with torch.no_grad():
            self.beta.copy_(self._beta_rp.init(torch.ones_like(self.beta)))
            eye = torch.eye(self.gamma.shape[0], dtype=self.gamma.dtype,
                            device=self.gamma.device)
            self.gamma.copy_(self._gamma_rp.init(self.gamma_init * eye))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gdn(x, self._beta_rp(self.beta), self._gamma_rp(self.gamma),
                   self.inverse)


def _channel_param(p: torch.Tensor) -> torch.Tensor:
    return p.reshape(1, -1, 1, 1)


class ChannelNorm2D(nn.Module):
    """HiFiC channel-dimension normalization (unbiased var, eps 1e-3)."""

    def __init__(self, ch: int, eps: float = 1e-3, affine: bool = True):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(ch)) if affine else None
        self.beta = nn.Parameter(torch.zeros(ch)) if affine else None

    def reset_parameters(self, generator=None) -> None:
        if self.gamma is not None:
            nn.init.ones_(self.gamma)
            nn.init.zeros_(self.beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = torch.mean(x, dim=1, keepdim=True)
        var = torch.var(x, dim=1, keepdim=True, correction=1)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        if self.gamma is not None:
            y = _channel_param(self.gamma) * y + _channel_param(self.beta)
        return y


class InstanceNorm2D(ChannelNorm2D):
    """torch InstanceNorm2d equivalent (biased var, eps 1e-5, affine)."""

    def __init__(self, ch: int, eps: float = 1e-5, affine: bool = True):
        super().__init__(ch, eps, affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu, var = image_moments(x)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        if self.gamma is not None:
            y = _channel_param(self.gamma) * y + _channel_param(self.beta)
        return y


def make_norm(norm_type: Optional[str], ch: int) -> Optional[nn.Module]:
    """The reference's norm_type switch ('CN' / 'IN' / 'none')."""
    if norm_type in (None, "none"):
        return None
    if norm_type == "CN":
        return ChannelNorm2D(ch)
    if norm_type == "IN":
        return InstanceNorm2D(ch)
    raise ValueError(f"unsupported norm_type: {norm_type}")


class BatchNorm2D(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over NCHW in training (flax's
    ``use_running_average=False``, which JAX's trainers always pass; see
    the module doc): it normalizes with the batch's moments, and
    ``update_stats`` moves the running ones."""

    def __init__(self, ch: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = torch.mean(xf, dim=(0, 2, 3))
        var = torch.clamp(torch.mean(xf * xf, dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        if update_stats:
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - _channel_param(mean)) * _channel_param(mul)
        return y + _channel_param(self.bias)

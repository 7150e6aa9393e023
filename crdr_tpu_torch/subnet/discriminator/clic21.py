"""CLIC21 GVAE patch discriminators and their multi-rate variants (NCHW).

Counterpart of ``crdr_tpu/subnet/discriminator/clic21.py`` (reference
clic21_gvae_discriminator.py:12-68, module_list_discriminator.py:14-30,
multirate_clic21_gvae_discriminator.py:122-284): conv stacks with 4
stride-2 downscales, channels 64 -> 512, a 1-channel logit map, and a
rate's module picked by ``rate_ind``.

Module names follow the flax tree (``layer_{i}``, ``head``, ``model``,
``backbone_{i}``, ``head_{i}``); the module list's ``subD_list.{i}`` is the
reference's torch name, which the exporter's rules map to flax's
``subD_{i}``.  JAX's ``lax.switch`` on a traced ``rate_ind`` becomes a
host-side index of the module list.
"""

from __future__ import annotations

import numbers

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm2D, Conv2d, make_norm
from ...utils.registry import DISCRIMINATOR_REGISTRY


def rate_index(rate_ind, n: int) -> int:
    """``int(rate_ind)`` (truncation, as ``astype(int32)``) of a host
    number, checked against ``n`` modules."""
    if not isinstance(rate_ind, numbers.Real):
        raise TypeError(f"rate_ind must be a number, not {type(rate_ind)}")
    i = int(rate_ind)
    if not 0 <= i < n:
        raise IndexError(f"rate_ind {rate_ind} is outside 0..{n - 1}")
    return i


class Discriminator(nn.Module):
    """Base of the registered discriminators: ``reset_parameters`` draws
    every parameter and state from one generator, in module order."""

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters") and \
                    not isinstance(m, Discriminator):
                m.reset_parameters(generator)


class ConvNormLRelu(nn.Module):
    """conv -> norm (``BN`` / ``IN`` / ``CN`` / ``none``) -> leaky ReLU 0.2
    (``_ConvNormLRelu``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, norm_type: str = "BN"):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride,
                           kernel_size // 2)
        self.norm_name = {"BN": "bn", "IN": "in", "CN": "cn"}.get(norm_type)
        if norm_type == "BN":
            self.add_module("bn", BatchNorm2D(out_ch))
        elif norm_type in ("IN", "CN"):
            self.add_module(self.norm_name, make_norm(norm_type, out_ch))
        elif norm_type != "none":
            raise ValueError(f"invalid norm_type {norm_type}")

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        x = self.conv(x)
        if self.norm_name == "bn":
            x = self.bn(x, update_stats)
        elif self.norm_name is not None:
            x = self._modules[self.norm_name](x)
        return F.leaky_relu(x, 0.2)


class Clic21Backbone(nn.Module):
    """``_Clic21Backbone``: layer_0 (no norm), a stride-2 layer, then
    ``num_downscale - 1`` (stride 1, stride 2) pairs doubling the channels up
    to 8 x main_ch; a 3x3 ``head`` unless ``head=False``."""

    def __init__(self, in_ch: int = 3, main_ch: int = 64, out_ch: int = 1,
                 norm_type: str = "BN", num_downscale: int = 4,
                 head: bool = True):
        super().__init__()
        m = main_ch
        layers = [ConvNormLRelu(in_ch, m, 3, 1, "none"),
                  ConvNormLRelu(m, m, 3, 2, norm_type)]
        ch = m
        for _ in range(num_downscale - 1):
            out = min(ch * 2, m * 8)
            layers += [ConvNormLRelu(ch, out, 3, 1, norm_type),
                       ConvNormLRelu(out, out, 3, 2, norm_type)]
            ch = out
        self.n_layers = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"layer_{i}", layer)
        self.out_features = ch
        self.head = Conv2d(ch, out_ch, 3, 1, 1) if head else None

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        for i in range(self.n_layers):
            x = self._modules[f"layer_{i}"](x, update_stats)
        return x if self.head is None else self.head(x)


@DISCRIMINATOR_REGISTRY.register()
class CLIC21GVAEDiscriminator(Discriminator):
    def __init__(self, in_ch: int = 3, out_ch: int = 1, main_ch: int = 64,
                 norm_type: str = "BN", num_downscale: int = 4):
        super().__init__()
        self.model = Clic21Backbone(in_ch, main_ch, out_ch, norm_type,
                                    num_downscale)

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        return self.model(x, update_stats)


@DISCRIMINATOR_REGISTRY.register()
class CLIC21GVAELatentConditionalDiscriminator(Discriminator):
    """Conditions on y_hat (detached): 1x1 conv -> latent_nc channels ->
    x16 bilinear upsample (``jax.image.resize``'s half-pixel rule, which
    ``align_corners=False`` is) -> concatenated after the image."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1, y_ch: int = 192,
                 latent_nc: int = 12, main_ch: int = 64,
                 norm_type: str = "BN"):
        super().__init__()
        self.latent_conv = ConvNormLRelu(y_ch, latent_nc, 1, 1, "none")
        self.model = Clic21Backbone(in_ch + latent_nc, main_ch, out_ch,
                                    norm_type)

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        if y_hat is None:
            raise ValueError("a latent-conditional discriminator needs y_hat")
        cond = self.latent_conv(y_hat.detach(), update_stats)
        h, w = cond.shape[2:]
        cond = F.interpolate(cond, size=(h * 16, w * 16), mode="bilinear",
                             align_corners=False)
        return self.model(torch.cat([x, cond], dim=1), update_stats)


@DISCRIMINATOR_REGISTRY.register()
class ModuleListDiscriminator(Discriminator):
    """N independent sub-discriminators, one per rate level, picked by
    ``rate_ind`` (stage 3)."""

    def __init__(self, _subd_type: str = "CLIC21GVAEDiscriminator",
                 _num_subd: int = 5, in_ch: int = 3, out_ch: int = 1,
                 main_ch: int = 64, norm_type: str = "none"):
        super().__init__()
        cls = DISCRIMINATOR_REGISTRY.get(_subd_type)
        self.subD_list = nn.ModuleList([
            cls(in_ch=in_ch, out_ch=out_ch, main_ch=main_ch,
                norm_type=norm_type) for _ in range(_num_subd)])

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        sub = self.subD_list[rate_index(rate_ind, len(self.subD_list))]
        return sub(x, update_stats=update_stats)


@DISCRIMINATOR_REGISTRY.register()
class SharedBackboneClic21GvaeDiscriminator(Discriminator):
    """A shared backbone and a 3x3 head per rate."""

    def __init__(self, rate_level: int = 5, in_ch: int = 3, out_ch: int = 1,
                 main_ch: int = 64, norm_type: str = "none"):
        super().__init__()
        self.rate_level = rate_level
        self.backbone = Clic21Backbone(in_ch, main_ch, out_ch, norm_type,
                                       head=False)
        for i in range(rate_level):
            self.add_module(f"head_{i}", Conv2d(self.backbone.out_features,
                                                out_ch, 3, 1, 1))

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        i = rate_index(rate_ind, self.rate_level)
        return self._modules[f"head_{i}"](self.backbone(x, update_stats))


@DISCRIMINATOR_REGISTRY.register()
class SharedHeadClic21GvaeDiscriminator(Discriminator):
    """A backbone per rate and one shared 3x3 head."""

    def __init__(self, rate_level: int = 5, in_ch: int = 3, out_ch: int = 1,
                 main_ch: int = 64, norm_type: str = "none"):
        super().__init__()
        self.rate_level = rate_level
        for i in range(rate_level):
            self.add_module(f"backbone_{i}", Clic21Backbone(
                in_ch, main_ch, out_ch, norm_type, head=False))
        self.head = Conv2d(self.backbone_0.out_features, out_ch, 3, 1, 1)

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        i = rate_index(rate_ind, self.rate_level)
        return self.head(self._modules[f"backbone_{i}"](x, update_stats))


@DISCRIMINATOR_REGISTRY.register()
class MultirateSeparateClic21GvaeDiscriminator(ModuleListDiscriminator):
    """Fully separate per-rate discriminators (the module list with the
    CLIC21 sub-discriminator)."""


@DISCRIMINATOR_REGISTRY.register()
class RateCondClic21GvaeDiscriminator(Discriminator):
    """One discriminator conditioned on the rate: its one-hot planes
    concatenated after the image."""

    def __init__(self, rate_level: int = 5, in_ch: int = 3, out_ch: int = 1,
                 main_ch: int = 64, norm_type: str = "none"):
        super().__init__()
        self.rate_level = rate_level
        self.model = Clic21Backbone(in_ch + rate_level, main_ch, out_ch,
                                    norm_type)

    def forward(self, x, rate_ind=None, y_hat=None,
                update_stats: bool = True):
        i = rate_index(rate_ind, self.rate_level)
        n, _, h, w = x.shape
        cond = x.new_zeros((n, self.rate_level, h, w))
        cond[:, i] = 1.0
        return self.model(torch.cat([x, cond], dim=1), update_stats)


@DISCRIMINATOR_REGISTRY.register()
class MultirateSharedRateCondClic21GvaeDiscriminator(
        RateCondClic21GvaeDiscriminator):
    """The reference's class name for the rate-conditioned discriminator."""

"""Checkerboard space-channel context model (ELIC, He et al. CVPR 2022).

Counterpart of ``crdr_tpu/subnet/context_model/checkerboard.py``.  Within
each Charm channel slice the latent positions split into a checkerboard of
anchors ((h + w) even) and non-anchors.  Anchors are coded from the channel
context alone, as Charm; non-anchors also condition on the decoded anchors
through one 5x5 conv a slice (``spatial_transforms_{i}``, 32 -> 64 channels
at the flagship's widths), so a slice takes two dense passes.  The anchors
are always quantized by rounding; the forward's second pass is eval or
training (the noise source's ``"y{i}"`` draw), as in Charm.

The module is NCHW, like the port's Charm one; ``split_checkerboard`` and
``merge_checkerboard`` work on the spatial axes 1 and 2 of NHWC tensors, as
JAX's.  The SliceTransforms have the Charm model's reference torch names
(``{mean,scale,lrp}_slice_transforms.{i}``).  The spatial convs have no
reference counterpart: they are named ``spatial_transforms_{i}``, the flax
name, so the JAX importer maps them with no rule of its own.  The codec
path runs the same weights through ``ops/cb_uniform.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ...nn import Conv2d
from ...utils.registry import CONTEXTMODEL_REGISTRY
from .charm import SliceTransform

Tensor = torch.Tensor


def anchor_mask(h: int, w: int, dtype=torch.float32, device=None) -> Tensor:
    """[H, W] with 1 at the anchors ((h + w) % 2 == 0)."""
    hh = torch.arange(h, device=device)[:, None]
    ww = torch.arange(w, device=device)[None, :]
    return ((hh + ww) % 2 == 0).to(dtype)


def split_checkerboard(x):
    """NHWC (tensor or array) -> (A1, A2, NA1, NA2) subgrids."""
    return (x[:, 0::2, 0::2], x[:, 1::2, 1::2],
            x[:, 0::2, 1::2], x[:, 1::2, 0::2])


def merge_checkerboard(a1: Tensor, a2: Tensor, na1: Tensor,
                       na2: Tensor) -> Tensor:
    """Inverse of ``split_checkerboard`` for NHWC tensors."""
    n, h2, w2, c = a1.shape
    out = a1.new_zeros((n, h2 * 2, w2 * 2, c))
    out[:, 0::2, 0::2] = a1
    out[:, 1::2, 1::2] = a2
    out[:, 0::2, 1::2] = na1
    out[:, 1::2, 0::2] = na2
    return out


@CONTEXTMODEL_REGISTRY.register()
class ElicCheckerboardCharmContextModel(nn.Module):
    """Charm channel context + checkerboard spatial context per slice."""

    def __init__(self, num_slices: int, bottleneck_y: int, hyper_out_ch: int,
                 max_support_slices: int = 5,
                 slice_transform_kwargs: Dict = None):
        super().__init__()
        assert bottleneck_y % num_slices == 0
        self.num_slices = num_slices
        self.max_support_slices = max_support_slices
        self.slice_ch = sc = bottleneck_y // num_slices
        kw = dict(slice_transform_kwargs or {})
        half = hyper_out_ch // 2

        def in_ch(i, kind):
            nsup = i if max_support_slices < 0 else min(i, max_support_slices)
            return half + nsup * sc + (sc if kind == "lrp" else 0)

        for kind in ("mean", "scale", "lrp"):
            setattr(self, f"{kind}_slice_transforms", nn.ModuleList(
                SliceTransform(in_ch(i, kind), sc, **kw)
                for i in range(num_slices)))
        for i in range(num_slices):
            setattr(self, f"spatial_transforms_{i}",
                    Conv2d(sc, 2 * sc, 5, 1, 2))

    def _supports(self, slices: List[Tensor]) -> List[Tensor]:
        if self.max_support_slices < 0:
            return slices
        return slices[:self.max_support_slices]

    def _mask(self, t: Tensor) -> Tensor:
        """The [1, 1, H, W] anchor mask of NCHW ``t``."""
        return anchor_mask(t.shape[2], t.shape[3], t.dtype, t.device)[None,
                                                                      None]

    def _slice_params(self, i: int, hyper_mean, hyper_scale, support):
        mean_in = torch.cat([hyper_mean] + support, dim=1)
        scale_in = torch.cat([hyper_scale] + support, dim=1)
        return (self.mean_slice_transforms[i](mean_in),
                self.scale_slice_transforms[i](scale_in), mean_in)

    def _spatial_delta(self, i: int, y_hat_anchor_masked: Tensor
                       ) -> Tuple[Tensor, Tensor]:
        delta = getattr(self, f"spatial_transforms_{i}")(y_hat_anchor_masked)
        return torch.chunk(delta, 2, dim=1)  # (d_mu, d_sigma)

    def _slices(self, y: Tensor, hyper_out: Tensor, entropy_model_y,
                noise: Optional[Callable] = None,
                calc_q_likelihood: bool = False):
        """Per slice: (mu_c, sigma_c, likelihood, q-likelihood or None);
        the y_hat list carries the LRP."""
        amask = self._mask(y)
        hyper_mean, hyper_scale = torch.chunk(hyper_out, 2, dim=1)
        y_hat_slices: List[Tensor] = []
        out = []
        for i, y_slice in enumerate(torch.chunk(y, self.num_slices, dim=1)):
            support = self._supports(y_hat_slices)
            mu, sigma, mean_in = self._slice_params(i, hyper_mean,
                                                    hyper_scale, support)
            # anchors quantized with the channel-context params
            y_hat_a = entropy_model_y(y_slice, torch.cat([mu, sigma], 1))[0]
            d_mu, d_sigma = self._spatial_delta(i, y_hat_a * amask)
            mu_c = mu + d_mu * (1.0 - amask)
            sigma_c = sigma + d_sigma * (1.0 - amask)
            params = torch.cat([mu_c, sigma_c], 1)
            y_hat_slice, lik = entropy_model_y(
                y_slice, params,
                None if noise is None else noise(f"y{i}", y_slice))
            q_lik = entropy_model_y(y_slice, params)[1].detach() \
                if calc_q_likelihood else None
            lrp_in = torch.cat([mean_in, y_hat_slice], dim=1)
            lrp = 0.5 * torch.tanh(self.lrp_slice_transforms[i](lrp_in))
            y_hat_slices.append(y_hat_slice + lrp)
            out.append((mu_c, sigma_c, lik, q_lik))
        return out, y_hat_slices

    def forward(self, y: Tensor, hyper_out: Tensor, entropy_model_y,
                noise: Optional[Callable] = None,
                calc_q_likelihood: bool = False):
        """(y_hat, y_likelihood[, y_q_likelihood]), NCHW.  Eval without
        ``noise`` (a noise source, ``entropy/ops.py``), training with it."""
        out, y_hat = self._slices(y, hyper_out, entropy_model_y, noise,
                                  calc_q_likelihood)
        res = (torch.cat(y_hat, 1), torch.cat([o[2] for o in out], 1))
        if calc_q_likelihood:
            return res + (torch.cat([o[3] for o in out], 1),)
        return res

    def forward_compress(self, y: Tensor, hyper_out: Tensor,
                         entropy_model_y):
        """(mu_c, sigma_c, y_hat, y_likelihood) with the combined anchor /
        non-anchor parameters, NCHW."""
        out, y_hat = self._slices(y, hyper_out, entropy_model_y)
        return (torch.cat([o[0] for o in out], 1),
                torch.cat([o[1] for o in out], 1), torch.cat(y_hat, 1),
                torch.cat([o[2] for o in out], 1))

    # ---- per-slice decode methods ----------------------------------------

    def decode_slice_base(self, i: int, hyper_mean: Tensor,
                          hyper_scale: Tensor, support: Tensor):
        """(mu, sigma) from the channel context only (anchor decode)."""
        mean_in = torch.cat([hyper_mean, support], dim=1)
        scale_in = torch.cat([hyper_scale, support], dim=1)
        return (self.mean_slice_transforms[i](mean_in),
                self.scale_slice_transforms[i](scale_in))

    def decode_slice_spatial(self, i: int, mu: Tensor, sigma: Tensor,
                             y_hat_anchor_masked: Tensor):
        """The combined (mu_c, sigma_c) once the anchors are decoded."""
        amask = self._mask(mu)
        d_mu, d_sigma = self._spatial_delta(i, y_hat_anchor_masked)
        return mu + d_mu * (1.0 - amask), sigma + d_sigma * (1.0 - amask)

    def decode_slice_lrp(self, i: int, hyper_mean: Tensor, support: Tensor,
                         y_hat_slice: Tensor) -> Tensor:
        lrp_in = torch.cat([hyper_mean, support, y_hat_slice], dim=1)
        return y_hat_slice + 0.5 * torch.tanh(
            self.lrp_slice_transforms[i](lrp_in))

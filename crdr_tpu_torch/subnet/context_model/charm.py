"""Channel-autoregressive (Charm) context model, Minnen & Singh ICIP 2020.

Counterpart of ``crdr_tpu/subnet/context_model/charm.py`` (reference
minnen20_charm_context_model.py:41-240), NCHW:

* y split into ``num_slices`` slices; supports capped at ``max_support_slices``;
* per slice, three SliceTransform CNNs (conv5->224, actv, conv5->128, actv,
  conv3->slice_ch): mean on [hyper_mean || y_hat_<i], scale likewise on
  hyper_scale, and an LRP whose ``0.5*tanh`` output is added to the slice;
* the forward evaluates likelihoods slice by slice, eval (rounding) or
  training (the noise source's ``"y{i}"`` draw for slice ``i``, JAX's
  ``fold_in(rng, i)``; with ``calc_q_likelihood`` also the rounded
  likelihoods, detached).  The codec path runs the same weights through the
  packed, shape-uniform step of ``ops/charm_uniform.py`` instead.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Conv2d
from ...utils.registry import CONTEXTMODEL_REGISTRY

# JAX's ``_ACTV`` (``slice_transform_kwargs: {actv: ...}``): flax's gelu is
# the tanh approximation, lrelu's slope 0.2
ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "lrelu": functools.partial(F.leaky_relu, negative_slope=0.2),
}


def activation(actv: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The SliceTransform activation ``actv`` as a function."""
    if actv not in ACTIVATIONS:
        raise ValueError(f"SliceTransform actv {actv!r}: one of "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[actv]


class Activation(nn.Module):
    """``activation(actv)`` as a module (it holds no parameter)."""

    def __init__(self, actv: str):
        super().__init__()
        self.actv, self.fn = actv, activation(actv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.actv


class SliceTransform(nn.Module):
    """conv5 -> actv -> conv5 -> actv -> conv3 (``ACTIVATIONS``)."""

    def __init__(self, in_ch: int, out_ch: int, actv: str = "relu"):
        super().__init__()
        self.model = nn.Sequential(
            Conv2d(in_ch, 224, 5, 1, 2), Activation(actv),
            Conv2d(224, 128, 5, 1, 2), Activation(actv),
            Conv2d(128, out_ch, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


@CONTEXTMODEL_REGISTRY.register()
class Minnen20CharmContextModel(nn.Module):
    def __init__(self, num_slices: int, bottleneck_y: int, hyper_out_ch: int,
                 max_support_slices: int = 5,
                 slice_transform_kwargs: Dict = None,
                 crop_gaussian_params: bool = False):
        super().__init__()
        assert bottleneck_y % num_slices == 0
        assert max_support_slices == -1 or 1 <= max_support_slices <= num_slices
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

    def _supports(self, y_hat_slices: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.max_support_slices < 0:
            return y_hat_slices
        return y_hat_slices[:self.max_support_slices]

    def forward(self, y: torch.Tensor, hyper_out: torch.Tensor,
                entropy_model_y, noise: Optional[Callable] = None,
                calc_q_likelihood: bool = False):
        """(y_hat, y_likelihood[, y_q_likelihood]), NCHW.  Eval without
        ``noise`` (a noise source, ``entropy/ops.py``), training with it."""
        y_slices = torch.chunk(y, self.num_slices, dim=1)
        hyper_mean, hyper_scale = torch.chunk(hyper_out, 2, dim=1)
        y_hat_slices: List[torch.Tensor] = []
        lik_slices: List[torch.Tensor] = []
        q_lik_slices: List[torch.Tensor] = []
        for i, y_slice in enumerate(y_slices):
            support = self._supports(y_hat_slices)
            mean_support = torch.cat([hyper_mean] + support, dim=1)
            scale_support = torch.cat([hyper_scale] + support, dim=1)
            mu = self.mean_slice_transforms[i](mean_support)
            sigma = self.scale_slice_transforms[i](scale_support)
            params = torch.cat([mu, sigma], dim=1)
            y_hat_slice, lik = entropy_model_y(
                y_slice, params,
                None if noise is None else noise(f"y{i}", y_slice))
            lik_slices.append(lik)
            if calc_q_likelihood:
                q_lik_slices.append(
                    entropy_model_y(y_slice, params)[1].detach())
            lrp_in = torch.cat([mean_support, y_hat_slice], dim=1)
            lrp = 0.5 * torch.tanh(self.lrp_slice_transforms[i](lrp_in))
            y_hat_slices.append(y_hat_slice + lrp)
        out = (torch.cat(y_hat_slices, dim=1), torch.cat(lik_slices, dim=1))
        if calc_q_likelihood:
            return out + (torch.cat(q_lik_slices, dim=1),)
        return out

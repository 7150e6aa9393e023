"""Conditional Gaussian entropy models for y (forwards) and the codec state.

Counterpart of ``crdr_tpu/entropy/gaussian.py`` (CompressAI
``GaussianConditional`` semantics):

* likelihood = Phi((0.5 - |y - mu|) / sigma) - Phi((-0.5 - |y - mu|) / sigma)
  with sigma lower-bounded at ``scale_bound`` and the likelihood floored at 1e-9;
* eval (no ``noise``): hard rounding around the mean;
* training (``noise``, U(-0.5, 0.5) like y): the likelihood of the noisy y,
  which is also the output; the STE variant outputs
  ``ste_round(y - mu) + mu``;
* coding uses a 64-entry log-spaced scale table (0.11 .. 256) and
  ``build_indexes = searchsorted(table, sigma)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

import torch
from torch import nn

from ..utils.registry import ENTROPYMODEL_REGISTRY
from .ops import (at_least_f32, lower_bound, standardized_cumulative,
                  ste_round)

LIKELIHOOD_BOUND = 1e-9
SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(minimum: float = SCALES_MIN, maximum: float = SCALES_MAX,
                    levels: int = SCALES_LEVELS) -> np.ndarray:
    """exp(linspace(log min, log max, levels)) in torch f32, CompressAI's
    default table (a 1-ulp drift can flip a ``build_indexes`` boundary)."""
    return torch.exp(torch.linspace(math.log(minimum), math.log(maximum),
                                    levels)).numpy()


def gaussian_likelihood(values: torch.Tensor, scales: torch.Tensor,
                        scale_bound: float) -> torch.Tensor:
    # rate math in f32 at least
    values = torch.abs(at_least_f32(values))
    scales = lower_bound(at_least_f32(scales), scale_bound)
    upper = standardized_cumulative((0.5 - values) / scales)
    lower = standardized_cumulative((-0.5 - values) / scales)
    return lower_bound(upper - lower, LIKELIHOOD_BOUND)


def build_indexes(scales: torch.Tensor, scale_table: torch.Tensor,
                  scale_bound: float) -> torch.Tensor:
    """Index of the smallest table entry >= scale (CompressAI build_indexes);
    scales above the table max are clamped to the last entry."""
    scales = torch.clamp(scales, min=scale_bound)
    idx = torch.searchsorted(scale_table, scales.contiguous(), right=False)
    return torch.clamp(idx, max=scale_table.numel() - 1).to(torch.int32)


@ENTROPYMODEL_REGISTRY.register()
class GaussianMeanScaleConditional(nn.Module):
    """params = concat([mean, scale], channel axis); NCHW."""

    def __init__(self, scale_bound: float = SCALES_MIN):
        super().__init__()
        self.scale_bound = scale_bound

    def forward(self, y: torch.Tensor, params: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, scale = torch.chunk(params, 2, dim=1)
        if noise is None:
            y_hat = torch.round(y - mean) + mean
        else:
            y_hat = y + noise
        return y_hat, gaussian_likelihood(y_hat - mean, scale,
                                          self.scale_bound)


@ENTROPYMODEL_REGISTRY.register()
class GaussianScaleConditional(nn.Module):
    """Scale-only conditional (params = scales), for Balle18-style models."""

    def __init__(self, scale_bound: float = SCALES_MIN):
        super().__init__()
        self.scale_bound = scale_bound

    def forward(self, y: torch.Tensor, params: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y_hat = torch.round(y) if noise is None else y + noise
        return y_hat, gaussian_likelihood(y_hat, params, self.scale_bound)


@ENTROPYMODEL_REGISTRY.register()
class SteGaussianMeanScaleConditional(GaussianMeanScaleConditional):
    """Noise likelihood + straight-through-rounded output (reference
    ste_gaussian_conditional.py:10-27); identical to the base in eval."""

    def __init__(self, scale_bound: float = SCALES_MIN,
                 entropy_quant_type: str = "noise"):
        super().__init__(scale_bound)
        assert entropy_quant_type == "noise"

    def forward(self, y: torch.Tensor, params: torch.Tensor,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y_hat, lik = super().forward(y, params, noise)
        if noise is None:
            return y_hat, lik
        mean = torch.chunk(params, 2, dim=1)[0]
        return ste_round(y - mean) + mean, lik


# ---------------------------------------------------------------------------
# Host-side codec state
# ---------------------------------------------------------------------------

class GaussianConditionalCodec:
    """CDF tables over the scale table (CompressAI
    ``GaussianConditional.update``), built with the same torch-f32
    arithmetic as the JAX package, so the integers are identical."""

    def __init__(self, scale_bound: float = SCALES_MIN, tail_mass: float = 1e-9):
        self.scale_bound = scale_bound
        self.tail_mass = tail_mass
        self.scale_table = None
        self.quantized_cdf = None
        self.cdf_length = None
        self.offset = None

    def update_scale_table(self, scale_table: np.ndarray) -> None:
        self.scale_table = np.asarray(scale_table, np.float64)
        self._build_tables()

    def _build_tables(self) -> None:
        from scipy.stats import norm

        from ..runtime import pmf_to_quantized_cdf

        multiplier = -float(norm.ppf(self.tail_mass / 2.0))
        pmf_center = np.ceil(
            np.asarray(self.scale_table, np.float32) * np.float32(multiplier)
        ).astype(np.int32)
        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())

        with torch.no_grad():
            center = torch.from_numpy(pmf_center)
            samples = torch.abs(
                torch.arange(max_length).int() - center[:, None]).float()
            ss = torch.from_numpy(
                np.asarray(self.scale_table, np.float32)).unsqueeze(1)
            const = -(2 ** -0.5)
            upper = 0.5 * torch.erfc(const * ((0.5 - samples) / ss))
            lower = 0.5 * torch.erfc(const * ((-0.5 - samples) / ss))
            pmf = (upper - lower).numpy()
            tail = (2.0 * lower[:, :1]).numpy()

        L = len(self.scale_table)
        cdf = np.zeros((L, max_length + 2), dtype=np.int32)
        for i in range(L):
            p = np.concatenate([pmf[i, :pmf_length[i]], tail[i]])
            row = pmf_to_quantized_cdf(p.astype(np.float32), 16)
            cdf[i, :len(row)] = row
        self.quantized_cdf = cdf
        self.cdf_length = (pmf_length + 2).astype(np.int32)
        self.offset = (-pmf_center).astype(np.int32)

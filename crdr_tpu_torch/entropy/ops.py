"""Bounding / Gaussian-CDF primitives shared by the entropy models
(counterpart of ``crdr_tpu/entropy/ops.py``).  ``lower_bound`` is the
forward ``max`` with JAX's custom VJP (CompressAI's LowerBound): the
gradient passes where ``x >= bound`` or where it is negative, so a clamped
value can still grow back."""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g,
                           torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBound.apply(x, bound)


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) computed as 0.5 * erfc(-x / sqrt(2)) (CompressAI formulation)."""
    return 0.5 * torch.erfc(-x / _SQRT2)

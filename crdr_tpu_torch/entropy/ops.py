"""Bounding / Gaussian-CDF / quantization primitives shared by the entropy
models (counterpart of ``crdr_tpu/entropy/ops.py``).  ``lower_bound`` is
the forward ``max`` with JAX's custom VJP (CompressAI's LowerBound): the
gradient passes where ``x >= bound`` or where it is negative, so a clamped
value can still grow back.  ``ste_round`` is straight-through rounding.

The training forwards add U(-0.5, 0.5) noise.  JAX draws it from split
keys, which the port cannot reproduce, so the port's forwards take the
noise from a *noise source*: a callable ``noise(name, like)`` returning a
tensor of ``like``'s shape, dtype and device.  The names follow JAX's key
tree: ``"z"`` (the bottleneck's key), ``"y"`` (a hyperprior's y key) and
``"y{i}"`` (slice ``i`` of a context model, ``fold_in(y key, i)``).
``UniformNoise`` draws from an explicit ``torch.Generator``; a test hands
the port JAX's own draws instead."""

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


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """The rate math's dtype: bf16 / f16 inputs go up to f32, f32 and f64
    stay as they are (a float64 step is a reference for the f32 ones)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.round(x) - x).detach()


class UniformNoise:
    """The training forward's noise source: U(-0.5, 0.5) in ``like``'s
    dtype, drawn on ``like``'s device from ``generator`` (which must live on
    that device).  ``name`` is not used: the draws come in call order.

    As rank ``rank`` of ``world`` (data parallel, ``like`` holding this
    rank's block of a global batch) it draws the global batch's noise and
    keeps its block: the values are those one process would draw for the
    same rows, and every rank's generator stays in the same state."""

    def __init__(self, generator: torch.Generator, rank: int = 0,
                 world: int = 1):
        self.generator = generator
        self.rank, self.world = rank, world

    def __call__(self, name: str, like: torch.Tensor) -> torch.Tensor:
        shape = (like.shape[0] * self.world,) + tuple(like.shape[1:])
        u = torch.rand(shape, generator=self.generator, device=like.device,
                       dtype=like.dtype)
        if self.world > 1:
            b = like.shape[0]
            u = u[self.rank * b:(self.rank + 1) * b]
        return u - 0.5


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) computed as 0.5 * erfc(-x / sqrt(2)) (CompressAI formulation)."""
    return 0.5 * torch.erfc(-x / _SQRT2)

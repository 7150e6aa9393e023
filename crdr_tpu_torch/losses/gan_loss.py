"""GAN losses (counterpart of ``crdr_tpu/losses/gan_loss.py``; reference
src/losses/gan_loss.py).

The binary cross-entropy on logits is the JAX package's formula,
``max(x, 0) - x * t + log1p(exp(-|x|))``, computed in the logits' dtype, so
that the function is the same one (``F.binary_cross_entropy_with_logits``
computes another expression).  ``is_disc`` drops the loss weight.
"""

from __future__ import annotations

from typing import List

import torch

from ..utils.registry import LOSS_REGISTRY


def _bce_with_logits(x: torch.Tensor, target: float) -> torch.Tensor:
    return torch.clamp(x, min=0) - x * target + torch.log1p(
        torch.exp(-torch.abs(x)))


@LOSS_REGISTRY.register()
class VanillaGANLoss:
    def __init__(self, loss_weight: float, real_label: float = 1.0,
                 fake_label: float = 0.0, loss_reduction: str = "mean"):
        self.lamb = loss_weight
        self.real_label = real_label
        self.fake_label = fake_label
        self.reduction = loss_reduction

    def __call__(self, x, is_real: bool, is_disc: bool = False, mask=None,
                 **kwargs):
        target = self.real_label if is_real else self.fake_label
        loss = _bce_with_logits(x, target)
        if mask is not None:
            loss = loss * mask
        loss = torch.mean(loss)
        return loss if is_disc else self.lamb * loss


@LOSS_REGISTRY.register()
class MaskedVanillaGANLoss(VanillaGANLoss):
    def __init__(self, loss_weight: float, real_label: float = 1.0,
                 fake_label: float = 0.0):
        super().__init__(loss_weight, real_label, fake_label, "none")


@LOSS_REGISTRY.register()
class MultiscaleVanillaGANLoss:
    def __init__(self, loss_weight: float):
        self.lamb = loss_weight

    def __call__(self, x: List, is_real: bool, is_disc: bool = False,
                 **kwargs):
        target = 1.0 if is_real else 0.0
        loss = sum(torch.mean(_bce_with_logits(f, target)) for f in x) / len(x)
        return loss if is_disc else self.lamb * loss


@LOSS_REGISTRY.register()
class HingeGANLoss:
    def __init__(self, loss_weight: float):
        self.lamb = loss_weight

    def __call__(self, x, is_real: bool, is_disc: bool = False, **kwargs):
        if is_disc:
            return torch.mean(torch.relu(1 - x) if is_real
                              else torch.relu(1 + x))
        if not is_real:
            raise ValueError("the G-side hinge loss needs is_real=True")
        return self.lamb * (-torch.mean(x))


@LOSS_REGISTRY.register()
class MultiscaleHingeGANLoss(HingeGANLoss):
    def __call__(self, x: List, is_real: bool, is_disc: bool = False,
                 **kwargs):
        return sum(HingeGANLoss.__call__(self, f, is_real=is_real,
                                         is_disc=is_disc) for f in x)

"""Perceptual (LPIPS) loss (counterpart of
``crdr_tpu/losses/perceptual_loss.py``; reference
src/losses/perceptual_loss.py:11-30).

Weights: ``weights_path`` (or the environment variable
``CRDR_LPIPS_WEIGHTS``) names the pickle that ``scripts/convert_weights.py
lpips`` writes (torchvision AlexNet + lpips head state dicts as numpy
arrays; it is read with an unpickler that admits numpy arrays only).
Without weights the loss REFUSES to build: training against randomly
initialized features silently optimizes garbage.  ``allow_random: True`` (or
``CRDR_ALLOW_RANDOM_LPIPS=1``) builds it on a seeded random init, for smoke
runs only.  The weights are frozen: no gradient, in no optimizer.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import torch
from torch import nn

from ..metrics.lpips import LPIPSAlex, init_lpips, load_lpips_params
from ..utils.registry import LOSS_REGISTRY

logger = logging.getLogger(__name__)


@LOSS_REGISTRY.register()
class LPIPSLoss(nn.Module):
    """weight * mean LPIPS-alex of NCHW [-1, 1] images; move it to the
    trainer's device with ``.to``."""

    def __init__(self, loss_weight: float, range_norm: bool = False,
                 net: str = "alex", weights_path: Optional[str] = None,
                 allow_random: bool = False):
        super().__init__()
        if net != "alex":
            raise ValueError("only the alex backbone is implemented")
        self.lamb = loss_weight
        self.range_norm = range_norm
        weights_path = weights_path or os.environ.get("CRDR_LPIPS_WEIGHTS")
        if weights_path and os.path.exists(weights_path):
            self.module = LPIPSAlex()
            self.module.load_state_dict(_load_weights(weights_path))
            logger.info(f"LPIPS weights loaded: {weights_path}")
        elif allow_random or os.environ.get("CRDR_ALLOW_RANDOM_LPIPS"):
            self.module = init_lpips()
            logger.warning(
                "LPIPS running with RANDOM weights (allow_random set); "
                "smoke-test mode only — not a real perceptual loss")
        else:
            raise FileNotFoundError(
                "LPIPSLoss requires pretrained AlexNet+lpips weights; none "
                f"found (weights_path={weights_path!r}, CRDR_LPIPS_WEIGHTS "
                "unset). Convert them with scripts/convert_weights.py lpips "
                "or set allow_random: True / CRDR_ALLOW_RANDOM_LPIPS=1 for "
                "smoke tests.")
        self.module.eval().requires_grad_(False)

    def forward(self, real_images, fake_images, **kwargs):
        if self.range_norm:
            real_images = (real_images - 0.5) * 2.0
            fake_images = (fake_images - 0.5) * 2.0
        return self.lamb * torch.mean(self.module(real_images, fake_images))


class _NumpyUnpickler(pickle.Unpickler):
    """Admits the classes a pickled dict of numpy arrays needs, no other."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"LPIPS weights may hold numpy arrays only, not {module}.{name}")
        return super().find_class(module, name)


def _load_weights(path: str):
    with open(path, "rb") as f:
        blob = _NumpyUnpickler(f).load()
    return load_lpips_params(blob["alexnet"], blob["lpips"])

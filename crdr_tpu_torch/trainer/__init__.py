"""Trainer construction (counterpart of ``crdr_tpu/trainer/__init__.py``;
reference src/trainer/__init__.py:10).  The port has the rate-distortion
trainer (stages 1 and 2); the GAN trainer of stage 3 is still to come."""

from __future__ import annotations

from ..utils.registry import TRAINER_REGISTRY
from . import rd_trainer  # noqa: F401  (registration side effects)
from .base_trainer import BaseTrainer


def build_trainer(opt, device=None) -> BaseTrainer:
    """The trainer of ``opt.trainer.type`` on ``device``: the GPU unless
    the caller passes ``device="cpu"`` (or the config's ``device`` says
    so); without a GPU the default raises."""
    return TRAINER_REGISTRY.get(opt.trainer.type)(opt, device)

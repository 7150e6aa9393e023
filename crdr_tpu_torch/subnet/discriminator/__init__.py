"""Discriminator construction (counterpart of
``crdr_tpu/subnet/discriminator/__init__.py``; reference
src/models/discriminator/__init__.py:15).

A discriminator is called ``d(x, rate_ind=None, y_hat=None,
update_stats=True)`` on NCHW images: ``rate_ind`` a host number (the
multi-rate classes pick their rate's module with ``int(rate_ind)``, a
truncation, as JAX's ``astype(int32)``), ``y_hat`` the quantized latent
(the latent-conditional classes detach it).  It computes what JAX's
discriminators compute with ``train=True``, which JAX's trainers always
pass (BatchNorm on the batch's moments; JAX's ``train=False`` has no
caller).  ``update_stats`` stores the state a call computes: BatchNorm's
running moments and spectral norm's ``u`` / ``sigma``.  A G step passes
``update_stats=False``, which computes the same function and stores
nothing, as JAX's G step throws the new stats away.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from ...utils.config import ConfigDict
from ...utils.registry import DISCRIMINATOR_REGISTRY
from . import clic21, hific  # noqa: F401  (registration side effects)
from .clic21 import Discriminator


def build_discriminator(opt: Dict,
                        generator: Optional[torch.Generator] = None
                        ) -> nn.Module:
    """The discriminator of ``opt`` (``type`` and the class's fields) on the
    current default device, every parameter and state initialized from
    ``generator`` (each sub-discriminator, head and backbone, as JAX's init
    touches them all)."""
    opt = copy.deepcopy(dict(opt))
    cls = DISCRIMINATOR_REGISTRY.get(opt.pop("type"))
    opt = {k: (v.to_dict() if isinstance(v, ConfigDict) else v)
           for k, v in opt.items()}
    d = cls(**opt)
    d.reset_parameters(generator)
    return d


__all__ = ["Discriminator", "build_discriminator"]

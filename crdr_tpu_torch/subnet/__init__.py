"""Subnet construction from config (reference src/models/subnet/__init__.py;
counterpart of ``crdr_tpu/subnet/__init__.py``)."""

from __future__ import annotations

import copy
from typing import Dict

from torch import nn

from .. import entropy  # noqa: F401  (registers the entropy models)
from ..utils.config import ConfigDict
from ..utils.registry import (CONTEXTMODEL_REGISTRY, DECODER_REGISTRY,
                              ENCODER_REGISTRY, ENTROPYMODEL_REGISTRY,
                              HYPERDECODER_REGISTRY, HYPERENCODER_REGISTRY)
from .autoencoder import (balle18, cheng20, elic,  # noqa: F401
                          elic_interpca, elic_interpca_beta_cond, hific)
from .context_model import charm, checkerboard  # noqa: F401
from .hyperprior import alt, minnen20  # noqa: F401

_REGISTRIES = {
    "encoder": ENCODER_REGISTRY,
    "decoder": DECODER_REGISTRY,
    "hyperencoder": HYPERENCODER_REGISTRY,
    "hyperdecoder": HYPERDECODER_REGISTRY,
    "context_model": CONTEXTMODEL_REGISTRY,
    "entropy_model": ENTROPYMODEL_REGISTRY,
}


def build_subnet(opt: Dict, subnet_type: str) -> nn.Module:
    opt = copy.deepcopy(dict(opt))
    cls = _REGISTRIES[subnet_type].get(opt.pop("type"))
    opt = {k: (v.to_dict() if isinstance(v, ConfigDict) else v)
           for k, v in opt.items()}
    return cls(**opt)

"""Dataset construction (counterpart of ``crdr_tpu/data/__init__.py``;
reference src/dataset/__init__.py:20-43)."""

from __future__ import annotations

import copy
from typing import Dict

from ..utils.config import ConfigDict
from ..utils.registry import DATASET_REGISTRY
from . import datasets  # noqa: F401  (registration side effects)
from .loader import DataLoader, cycle


def build_dataset(opt: Dict, is_train: bool = False):
    opt = copy.deepcopy(dict(opt))
    name = opt.pop("name", "")
    dtype = opt.pop("type", "ImageDataset")
    # the reference keys the registry by name + type, e.g. 'openimage' +
    # 'ImageDataset' -> OpenImageImageDataset; resolved case-insensitively
    candidates = [f"{name}{dtype}", dtype]
    lower_map = {k.lower(): k for k in DATASET_REGISTRY.keys()}
    cls = None
    for cand in candidates:
        key = lower_map.get(cand.lower())
        if key is not None:
            cls = DATASET_REGISTRY.get(key)
            break
    if cls is None:
        raise KeyError(f"no dataset registered for {candidates}")
    opt = {k: (v.to_dict() if isinstance(v, ConfigDict) else v)
           for k, v in opt.items()}
    return cls(is_train=is_train, **opt)

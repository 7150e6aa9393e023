"""Name->class registries powering config-driven construction.

The port's own instances: it never registers into the JAX package's
registries.  Same taxonomy as the reference (src/utils/registry.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, type] = {}

    def _do_register(self, name: str, obj: type) -> None:
        if name in self._obj_map:
            raise KeyError(f"'{name}' already registered in '{self._name}' registry")
        self._obj_map[name] = obj

    def register(self, obj: Optional[type] = None) -> Callable:
        if obj is None:
            def deco(cls):
                self._do_register(cls.__name__, cls)
                return cls
            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def keys(self):
        return self._obj_map.keys()

    def get(self, name: str):
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]


MODEL_REGISTRY = Registry("model")
ENCODER_REGISTRY = Registry("encoder")
DECODER_REGISTRY = Registry("decoder")
HYPERENCODER_REGISTRY = Registry("hyperencoder")
HYPERDECODER_REGISTRY = Registry("hyperdecoder")
CONTEXTMODEL_REGISTRY = Registry("context_model")
ENTROPYMODEL_REGISTRY = Registry("entropy_model")
LOSS_REGISTRY = Registry("loss")
DATASET_REGISTRY = Registry("dataset")
TRAINER_REGISTRY = Registry("trainer")
DISCRIMINATOR_REGISTRY = Registry("discriminator")

"""JAX package param tree -> the port's ``state_dict`` (reference torch names).

The inverse of ``crdr_tpu/importers/torch_import.py``: for every key of the
port's ``state_dict`` (which are the reference torch names), the forward
rename rules below (a copy of that importer's ``_RULES``) give the flax path,
and the layout transform is inverted:

* Conv2d      HWIO            -> OIHW               transpose(3, 2, 0, 1)
* ConvTransp. HWIO, flipped   -> (in, out, kh, kw)  un-flip, transpose(2, 3, 0, 1)
* Linear      (in, out)       -> (out, in)          .T  (Dense weights only:
  GDN's square ``gamma`` is [C_out, C_in] in both trees and passes as is)
* InterpCA    (L, C)          -> (L, 1, C, 1, 1)
* EntropyBottleneck matrices_K/biases_K/factors_K -> _matrixK/_biasK/_factorK

``export_discriminator_state`` carries a discriminator's ``params`` and its
state (``batch_stats``: BatchNorm's ``mean`` / ``var``, spectral norm's
``u`` / ``sigma``, which flax files under ``SpectralNorm_0`` as
``conv/weight/u`` / ``conv/weight/sigma``) into the port's discriminator.

The flax tree is nested dicts of numpy arrays (``jax.device_get`` of the
params); nothing of the JAX package is imported.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

import torch
from torch import nn

from ..nn import ConvTranspose2d, Dense

_RULES: List[Tuple[str, str]] = [
    (r"\.interp_ca_list\.(\d+)\.", r".interp_ca_\1."),
    (r"\.(mean|scale|lrp)_slice_transforms\.(\d+)\.model\.(\d+)\.",
     r".\1_slice_transforms_\2.model_\3."),
    (r"\.conv\.(\d+)\.", r".conv_\1."),
    (r"\.trunk_block\.(\d+)\.", r".trunk_block_\1."),
    (r"\.attention_block\.(\d+)\.", r".attention_block_\1."),
    (r"\.mlp\.(\d+)\.", r".mlp_\1."),
    (r"\._matrix(\d+)$", r".matrices_\1"),
    (r"\._bias(\d+)$", r".biases_\1"),
    (r"\._factor(\d+)$", r".factors_\1"),
    (r"(^|\.)subD_list\.(\d+)\.", r"\1subD_\2."),
]
# a spectral norm's state: the port's SNConv buffers -> flax's names
_SN_STATE = (r"\.(u|sigma)$", r".SpectralNorm_0.conv/weight/\1")

# ELIC layer names that live under the `body` submodule of the JAX InterpCA nets
_ELIC_BODY_LAYERS = r"(conv[1-4]|block[1-3]|attn[1-4])"


def map_reference_name(name: str, use_rate: bool, use_beta: bool,
                       pixel_shuffle: bool = False) -> str:
    """Reference torch state_dict key -> flax param path (dot-joined).  The
    ELIC decoder's up-convs are ``convN.deconv`` in the flax tree, or
    ``convN.conv_0`` with ``pixel_shuffle``."""
    for pat, rep in _RULES:
        name = re.sub(pat, rep, name)
    if use_rate:
        name = re.sub(rf"^encoder\.{_ELIC_BODY_LAYERS}\.",
                      r"encoder.body.\1.", name)
        if not use_beta:
            name = re.sub(rf"^decoder\.{_ELIC_BODY_LAYERS}\.",
                          r"decoder.body.\1.", name)
    inner = "conv_0" if pixel_shuffle else "deconv"
    return re.sub(r"^decoder\.(body\.)?conv([1-4])\.(weight|bias)$",
                  rf"decoder.\1conv\2.{inner}.\3", name)


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.array(v, np.float32)
    return out


def _to_torch_layout(arr: np.ndarray, shape: Tuple[int, ...],
                     kind: str) -> np.ndarray:
    if len(shape) == 5:          # InterpCA (L, C) -> (L, 1, C, 1, 1)
        out = arr.reshape(shape)
    elif kind == "dense":        # Linear (in, out) -> (out, in)
        out = arr.T
    elif len(shape) == 4 and kind == "deconv":
        out = arr[::-1, ::-1].transpose(2, 3, 0, 1)
    elif len(shape) == 4:
        out = arr.transpose(3, 2, 0, 1)
    else:
        out = arr
    if out.shape != shape:
        raise ValueError(f"cannot convert {arr.shape} -> {shape}")
    return np.ascontiguousarray(out)


def export_state_dict(params: Dict, net: nn.Module, use_rate: bool,
                      use_beta: bool, pixel_shuffle: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Strict: every port key finds its flax leaf and every leaf is used."""
    flat = _flatten(params)
    # the layout of a weight follows its module's type, not its shape
    kinds = {f"{name}.weight": "deconv" if isinstance(m, ConvTranspose2d)
             else "dense" for name, m in net.named_modules()
             if isinstance(m, (ConvTranspose2d, Dense))}
    out, used = {}, set()
    for key, ref in net.state_dict().items():
        path = map_reference_name(key, use_rate, use_beta, pixel_shuffle)
        if path not in flat:
            raise KeyError(f"{key}: no flax param {path}")
        out[key] = torch.from_numpy(_to_torch_layout(
            flat[path], tuple(ref.shape), kinds.get(key, "")))
        used.add(path)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax params unused (e.g. {unused[:4]})")
    return out


def export_discriminator_state(variables: Dict, d: nn.Module
                               ) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a discriminator -> the port
    discriminator ``d``'s ``state_dict``.  Strict: every key of ``d``
    finds its leaf and every leaf is used."""
    flat = {f"params.{k}": v
            for k, v in _flatten(variables.get("params", {})).items()}
    flat.update({f"batch_stats.{k}": v for k, v in
                 _flatten(variables.get("batch_stats", {})).items()})
    buffers = {n for n, _ in d.named_buffers()}
    out, used = {}, set()
    for key, ref in d.state_dict().items():
        path = map_reference_name(key, False, False)
        if key in buffers:
            path = "batch_stats." + re.sub(*_SN_STATE, path)
        else:
            path = "params." + path
        if path not in flat:
            raise KeyError(f"{key}: no flax variable {path}")
        out[key] = torch.from_numpy(_to_torch_layout(
            flat[path], tuple(ref.shape), ""))
        used.add(path)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} flax variables unused "
                       f"(e.g. {unused[:4]})")
    return out

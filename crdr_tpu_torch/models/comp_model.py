"""Composed compression models: the public model API of the port.

Counterpart of ``crdr_tpu/models/comp_model.py``.  Contracts kept:

* images flow in [-1, 1]; codec inputs are reflect-padded to a multiple of
  the stride (64, or ``shape_bucket``) and outputs cropped + clamped;
* ``codec_uint8_io`` ships raw uint8 pixels and converts them on the device
  with the exact f32 formulas of ``uint8_to_tensor``;
* ``transform_dtype: bfloat16`` runs the side-local analysis / synthesis
  transforms on bf16 copies of their weights; the hyper-decoder and the Charm
  chain stay f32 (the GDN kernel takes f32 only, so the Balle18 family
  raises on the card in bf16);
* ``state_dict`` / ``load_state_dict`` use the reference torch names.

Of the seven model classes the flagship
``BetaCondInterpCaHyperpriorCharmModel`` and the generic
``HyperpriorModel`` (no rate, no beta, no Charm) are ported so far.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

import torch

from ..entropy import EntropyBottleneck
from ..nn import GDN, Conv2d, ConvTranspose2d, Dense, InterpChAtt
from ..utils.config import ConfigDict
from ..utils.device import resolve_device
from ..utils.img_utils import crop_image, pad_image
from ..utils.registry import MODEL_REGISTRY
from .codec import CodecMixin
from .codec_devicewire import DeviceWireCodecMixin
from .net import CompNet

_INIT_MODULES = (Conv2d, ConvTranspose2d, Dense, InterpChAtt, EntropyBottleneck,
                 GDN)


class BaseModel(CodecMixin, DeviceWireCodecMixin):
    """Holds the network on its device, plus the codec state."""

    use_rate = False
    use_beta = False
    use_charm = False

    def __init__(self, opt, device: Union[str, torch.device, None] = None):
        self.opt = opt
        self.device = resolve_device(device)
        bucket = int(opt.get("shape_bucket", 64))
        if bucket % 64 or bucket <= 0:
            raise ValueError("shape_bucket must be a positive multiple of 64")
        self.stride = bucket
        subnet_opt = opt.subnet.to_dict() if isinstance(opt.subnet, ConfigDict) \
            else dict(opt.subnet)
        self.convert_img_range = bool(opt.get("convert_img_range_to_01", False))
        self.codec_uint8_io = bool(opt.get("codec_uint8_io", False))
        with self.device:
            self.net = CompNet(subnet_opt, use_rate=self.use_rate,
                               use_beta=self.use_beta, use_charm=self.use_charm,
                               img_range_01=self.convert_img_range)
        self.net.eval().requires_grad_(False)
        self.init_params(opt.get("seed", 0))
        cm = subnet_opt.get("context_model")
        self.context_type = cm["type"] if cm is not None else None
        if cm is not None:
            self.num_slices = cm["num_slices"]
            self.slice_ch = cm["bottleneck_y"] // cm["num_slices"]
            self.max_support_slices = cm.get("max_support_slices", 5)
        self.codec_z = None
        self.codec_y = None

    # ---------------- parameters ---------------------------------------------

    def init_params(self, seed: int = 0) -> None:
        """Random init from ``seed`` with a ``torch.Generator`` on the model's
        device (torch-default / DCGAN / InterpCA / bottleneck initializers,
        as the JAX package draws them; the values differ from JAX's; GDN's
        init is deterministic)."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for m in self.net.modules():
            if isinstance(m, _INIT_MODULES):
                m.reset_parameters(g)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_state_dict(self, state: Dict[str, torch.Tensor],
                        strict: bool = True) -> None:
        """Load reference-named weights; call ``codec_setup`` again after."""
        self.net.load_state_dict(state, strict=strict)

    # ---------------- pre/post processing -------------------------------------

    @property
    def transform_dtype(self) -> Optional[torch.dtype]:
        """bf16 for the side-local transforms (``transform_dtype``), else None."""
        dt = self.opt.get("transform_dtype", None)
        if dt in ("bf16", "bfloat16"):
            return torch.bfloat16
        if dt not in (None, "float32", "f32"):
            raise ValueError(f"transform_dtype {dt!r}")
        return None

    def data_preprocess(self, real_images: np.ndarray) -> np.ndarray:
        out = np.asarray(real_images, np.float32)
        if self.convert_img_range:  # [-1,1] -> [0,1]
            out = (out + 1.0) / 2.0
        return pad_image(out, self.stride)

    def data_postprocess(self, img: np.ndarray, size: Tuple[int, int]
                         ) -> np.ndarray:
        img = np.asarray(img)
        if self.convert_img_range:  # [0,1] -> [-1,1]
            img = (img - 0.5) * 2.0
        return np.clip(crop_image(img, *size), -1.0, 1.0)


@MODEL_REGISTRY.register()
class HyperpriorModel(BaseModel):
    """Mean-scale hyperprior: the generic codec (``models/codec.py``)."""


@MODEL_REGISTRY.register()
class BetaCondInterpCaHyperpriorCharmModel(BaseModel):
    use_rate = True
    use_beta = True
    use_charm = True

    def __init__(self, opt, device=None):
        if opt.subnet.encoder.rate_level != opt.subnet.decoder.rate_level:
            raise ValueError("encoder and decoder rate_level differ")
        self.rate_level = opt.subnet.encoder.rate_level
        self.max_beta: float = opt.subnet.decoder.max_beta
        super().__init__(opt, device)

"""Composed compression models: the public model API of the port.

Counterpart of ``crdr_tpu/models/comp_model.py``.  Contracts kept:

* images flow in [-1, 1]; codec and eval inputs are reflect-padded to a
  multiple of the stride (64, or ``shape_bucket``) and outputs cropped +
  clamped;
* ``codec_uint8_io`` ships raw uint8 pixels and converts them on the device
  with the exact f32 formulas of ``uint8_to_tensor``;
* ``transform_dtype: bfloat16`` runs the side-local analysis / synthesis
  transforms on bf16 copies of their weights; the hyper-decoder and the Charm
  chain stay f32 (the GDN kernel takes f32 only, so the Balle18 family
  raises on the card in bf16);
* ``codec_precision`` (``highest``: f32; ``default``: TF32 in the
  hyper-decoder and the plain Charm chain) governs the codec chain and the
  eval forward;
* ``state_dict`` / ``load_state_dict`` use the reference torch names, and
  ``load_state_dict`` merges partially, as the JAX package's does (the
  stage-1 -> stage-2 -> stage-3 handoff);
* training draws one ``rate_ind`` per batch and beta = max_beta *
  U{0..100} / 100 from the model's numpy generator seeded with ``seed``
  (JAX's sequence for the same seed), and the training forward's noise from
  a ``torch.Generator`` on the model's device.

All seven model classes are ported: ``HyperpriorModel``,
``HyperpriorCharmModel``, ``InterpCaHyperpriorModel``,
``InterpCaHyperpriorCharmModel``, ``BetaCondInterpCaHyperpriorModel`` and
the flagship ``BetaCondInterpCaHyperpriorCharmModel``, each with the codec,
the eval and training forwards (``run_model``) and ``validation``; the
Charm classes take either context model (``Minnen20CharmContextModel`` or
the checkerboard ``ElicCheckerboardCharmContextModel``).  The net is built
frozen (``requires_grad`` off), as the codec wants it; a trainer
(``trainer/``) turns its gradients on.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

import torch

from ..entropy import EntropyBottleneck, UniformNoise
from ..nn import GDN, Conv2d, ConvTranspose2d, Dense, InterpChAtt
from ..runtime.aot import AotSlot
from ..utils.config import ConfigDict
from ..utils.device import resolve_device
from ..utils.img_utils import (calc_ms_ssim, calc_psnr, crop_image, imwrite,
                               pad_image)
from ..utils.registry import MODEL_REGISTRY
from .codec import CodecMixin, codec_numerics, precision_allows_tf32
from .codec_devicewire import DeviceWireCodecMixin
from .net import CompNet

_INIT_MODULES = (Conv2d, ConvTranspose2d, Dense, InterpChAtt, EntropyBottleneck,
                 GDN)
# buffers of a reference checkpoint that the codec rebuilds at setup instead
# of loading (the port's modules hold no such buffers)
_REBUILT_BUFFERS = ("_quantized_cdf", "_offset", "_cdf_length", "scale_table",
                    "target", "pedestal", "bound")
# the headers crdr_tpu/utils/saver.py writes before its msgpack / pickle body
_JAX_CKPT_MAGIC = (b"MSGP", b"PKLE")
logger = logging.getLogger(__name__)


def _rate_summary(out: Dict, num_pixel: int) -> Dict[str, torch.Tensor]:
    """bpp, qbpp, y_bpp and z_bpp per image: -sum log2 p over the ORIGINAL
    pixel count, not the padded one (counterpart of
    ``crdr_tpu/models/codec_common.py::_rate_summary``)."""
    def bpp(lik):
        dims = tuple(range(1, lik.dim()))
        return -torch.sum(torch.log(lik), dim=dims) / math.log(2.0) \
            / num_pixel

    y_bpp, z_bpp = bpp(out["likelihoods"]["y"]), bpp(out["likelihoods"]["z"])
    qbpp = bpp(out["q_likelihoods"]["y"]) + bpp(out["q_likelihoods"]["z"])
    return {"bpp": y_bpp + z_bpp, "qbpp": qbpp, "y_bpp": y_bpp,
            "z_bpp": z_bpp}


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).cpu().numpy()


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
        self._np_rng = np.random.default_rng(opt.get("seed", None))
        self.noise = UniformNoise(torch.Generator(
            device=self.device).manual_seed(int(opt.get("seed", 0))))
        cm = subnet_opt.get("context_model")
        self.context_type = cm["type"] if cm is not None else None
        if cm is not None:
            self.num_slices = cm["num_slices"]
            self.slice_ch = cm["bottleneck_y"] // cm["num_slices"]
            self.max_support_slices = cm.get("max_support_slices", 5)
        self.codec_z = None
        self.codec_y = None
        self._aot = AotSlot()  # AOT package / recorder (runtime/aot.py)

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

    def load_state_dict(self, state: Dict[str, Any], strict: bool = False
                        ) -> Dict[str, int]:
        """Load reference-named weights.  By default a partial merge, as the
        JAX package's ``load_state_dict``: each tensor of the model whose
        name is in ``state`` with the same shape loads, the others keep
        their init (new modules, e.g. a stage-2 model's InterpCA from a
        stage-1 checkpoint) and are counted; names of ``state`` the model
        lacks are ignored.  ``strict=True`` requires the exact key set.
        Returns ``{"loaded": n, "kept": m}``.  The codec tables are dropped:
        call ``codec_setup()`` again before the codec."""
        self.codec_z = self.codec_y = None
        if strict:
            self.net.load_state_dict(state, strict=True)
            return {"loaded": len(state), "kept": 0}
        counts = {"loaded": 0, "kept": 0}
        with torch.no_grad():
            for name, cur in self.net.state_dict().items():
                new = state.get(name)
                if new is not None and tuple(new.shape) == tuple(cur.shape):
                    cur.copy_(torch.as_tensor(new))
                    counts["loaded"] += 1
                else:
                    counts["kept"] += 1
        if counts["kept"]:
            logger.info(f"partial load: {counts['loaded']} tensors loaded, "
                        f"{counts['kept']} kept at init (new modules)")
        return counts

    def load_learned_weight(self, ckpt_path: str) -> Dict[str, int]:
        """Load a ``torch.save`` checkpoint: a reference ``.pth`` /
        ``.pth.tar`` / ``.pt``, or the port's own ``.ckpt`` (``{"comp_model":
        state_dict}``).  Its ``comp_model`` entry (or the whole file) is a
        reference-named state_dict; a ``module.`` prefix (DataParallel) is
        stripped, and it loads by ``load_state_dict``'s partial merge.  The
        file is read with ``weights_only=True``: tensors and plain
        containers only, no code runs.  A checkpoint of the JAX package's
        saver (a msgpack pytree) raises.  Call ``codec_setup()`` after."""
        with open(ckpt_path, "rb") as f:
            head = f.read(4)
        if head in _JAX_CKPT_MAGIC:
            raise ValueError(
                f"{ckpt_path} was written by the JAX package's saver (a "
                "msgpack pytree), which the port does not read; give it a "
                "torch.save checkpoint (.pth / .pth.tar / .pt, or the port's "
                ".ckpt)")
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        state = ckpt.get("comp_model", ckpt)
        state = {k[len("module."):] if k.startswith("module.") else k: v
                 for k, v in state.items()}
        counts = self.load_state_dict(state)
        own = self.net.state_dict()
        unused = [k for k in state
                  if k not in own and not k.endswith(_REBUILT_BUFFERS)]
        if unused:
            logger.warning(f"{len(unused)} checkpoint tensors match no "
                           f"parameter (e.g. {unused[:4]})")
        logger.info(f"loaded checkpoint: {ckpt_path}")
        return counts

    @property
    def _is_checkerboard(self) -> bool:
        return self.context_type == "ElicCheckerboardCharmContextModel"

    # ---------------- precision ------------------------------------------------

    @property
    def codec_precision(self) -> str:
        """``highest`` (f32: entropy parameters reproducible across
        platforms) or ``default`` (TF32 in the hyper-decoder and the plain
        Charm chain, encode and decode alike)."""
        return self.opt.get("codec_precision", "highest")

    @property
    def chain_tf32(self) -> bool:
        """Whether the codec chain and the eval forward may use TF32."""
        return precision_allows_tf32(self.codec_precision)

    @property
    def transform_precision(self) -> str:
        """Precision of the side-local analysis / synthesis transforms on
        the codec path; defaults to ``codec_precision``."""
        return self.opt.get("transform_precision", self.codec_precision)

    @property
    def transform_dtype(self) -> Optional[torch.dtype]:
        """bf16 for the side-local transforms (``transform_dtype``), else None."""
        dt = self.opt.get("transform_dtype", None)
        if dt in ("bf16", "bfloat16"):
            return torch.bfloat16
        if dt not in (None, "float32", "f32"):
            raise ValueError(f"transform_dtype {dt!r}")
        return None

    # ---------------- pre/post processing -------------------------------------

    def data_preprocess(self, real_images: np.ndarray,
                        is_train: bool = False) -> np.ndarray:
        out = np.asarray(real_images, np.float32)
        if self.convert_img_range:  # [-1,1] -> [0,1]
            out = (out + 1.0) / 2.0
        return out if is_train else pad_image(out, self.stride)

    def data_postprocess(self, img: np.ndarray, size: Tuple[int, int],
                         is_train: bool = False) -> np.ndarray:
        img = np.asarray(img)
        if self.convert_img_range:  # [0,1] -> [-1,1]
            img = (img - 0.5) * 2.0
        if is_train:
            return img
        return np.clip(crop_image(img, *size), -1.0, 1.0)

    # ---------------- sampling (training-time controls) ---------------------

    def sample_rate_ind(self) -> float:
        return float(self._np_rng.integers(0, self.rate_level))

    def sample_beta(self) -> float:
        return self.max_beta * float(self._np_rng.integers(0, 101)) / 100.0

    # ---------------- forward ----------------------------------------------------

    def forward(self, real_images: np.ndarray, rate_ind=None, beta=None,
                is_train: bool = True, num_pixel: Optional[int] = None,
                noise=None):
        """The net's forward on NHWC images (padded for eval).  Eval runs
        under the codec numerics (``codec_precision``, no gradients); the
        training forward keeps the graph and takes its noise from ``noise``
        (a noise source, ``entropy/ops.py``), by default the model's own.
        Returns (the net's output dict, NCHW tensors on the device; the rate
        summary, [N] tensors)."""
        x = torch.from_numpy(np.ascontiguousarray(real_images, np.float32))
        x = x.to(self.device).permute(0, 3, 1, 2)
        ri, bt = (None if v is None else
                  torch.tensor([float(v)], dtype=torch.float32,
                               device=self.device) for v in (rate_ind, beta))
        if num_pixel is None:
            num_pixel = x.shape[2] * x.shape[3]
        if is_train:
            out = self.net(x, ri, bt, noise or self.noise)
            return out, _rate_summary(out, num_pixel)
        with codec_numerics(self.chain_tf32):
            out = self.net(x, ri, bt)
            return out, _rate_summary(out, num_pixel)

    def run_model(self, real_images, rate_ind=None, beta=None,
                  is_train: bool = True) -> Dict:
        """The reconstruction and the rate of N images (NHWC in [-1, 1]).
        Eval pads, crops and clamps, and needs ``rate_ind`` / ``beta`` where
        the class has them; training samples the missing ones and runs the
        training forward (noise, STE), no gradients kept."""
        real_images = np.asarray(real_images)
        _, H, W, _ = real_images.shape
        x = self.data_preprocess(real_images, is_train)
        if self.use_rate and rate_ind is None:
            if not is_train:
                raise ValueError(
                    '"rate_ind" must be specified if is_train=False')
            rate_ind = self.sample_rate_ind()
        if self.use_beta and beta is None:
            if not is_train:
                raise ValueError('"beta" must be specified if is_train=False')
            beta = self.sample_beta()
        with torch.no_grad():
            out, summary = self.forward(
                x, rate_ind if self.use_rate else None,
                beta if self.use_beta else None, is_train=is_train,
                num_pixel=H * W)
        result = dict(
            real_images=self.data_postprocess(x, (H, W), is_train),
            fake_images=self.data_postprocess(_nhwc(out["fake_images"]),
                                              (H, W), is_train),
            y_hat=_nhwc(out["quantized_code"]["y"]),
            z_hat=_nhwc(out["quantized_code"]["z"]),
            **{k: v.cpu().numpy() for k, v in summary.items()})
        if self.use_rate:
            result["rate_ind"] = rate_ind
        if self.use_beta:
            result["beta"] = beta
        return result

    # ---------------- validation ------------------------------------------------

    def validation(self, dataloader: Iterable[Dict], max_sample_size: int = 100,
                   save_img: bool = False, save_dir: str = "",
                   use_tqdm: bool = False) -> List[Dict[str, float]]:
        """bpp, PSNR and MS-SSIM of each sample of ``dataloader`` (dicts of
        ``run_model`` arguments, e.g. ``{"real_images": [1, H, W, 3]}``): at
        every rate with beta = max_beta / 2 for the multi-rate classes
        (columns ``bpp_{q+1}``, ``psnr_{q+1}``, ``ms_ssim_{q+1}``), else one
        pass (``bpp``, ``psnr``, ``ms_ssim``).  Returns one row dict per
        sample, with ``idx`` from 1: the records JAX's
        ``pd.json_normalize(rows)`` holds (the port does not need pandas).
        ``use_tqdm`` is accepted and unused, as in JAX."""
        rows = []
        for idx, data in enumerate(dataloader):
            row: Dict[str, Any] = {"idx": idx + 1}
            if self.use_rate:
                for q in range(self.rate_level):
                    kw = {"rate_ind": float(q)}
                    if self.use_beta:
                        kw["beta"] = self.max_beta / 2
                    out = self.run_model(**data, is_train=False, **kw)
                    row.update(self._metrics(out, f"_{q + 1}"))
                    self._maybe_save(save_img, save_dir, idx, q, out)
            else:
                out = self.run_model(**data, is_train=False)
                row.update(self._metrics(out, ""))
                self._maybe_save(save_img, save_dir, idx, None, out)
            rows.append(row)
            if idx + 1 >= max_sample_size:
                break
        return rows

    def _metrics(self, out: Dict, suffix: str) -> Dict[str, float]:
        real, fake = out["real_images"], out["fake_images"]
        return {f"bpp{suffix}": float(np.mean(out["bpp"])),
                f"psnr{suffix}": calc_psnr(real, fake),
                f"ms_ssim{suffix}": calc_ms_ssim(real, fake,
                                                 device=self.device)}

    def _maybe_save(self, save_img, save_dir, idx, q, out) -> None:
        """The samples as the JAX package names them, JPEGs byte-equal to
        its cv2 ones (``utils/jpeg.py::encode_jpeg``)."""
        if not save_img:
            return
        suffix = f"_q{q}" if q is not None else ""
        imwrite(os.path.join(save_dir, f"sample_{idx + 1}_fake{suffix}.jpg"),
                out["fake_images"])
        if q in (None, 0):
            imwrite(os.path.join(save_dir, f"sample_{idx + 1}_real.jpg"),
                    out["real_images"])


# ---------------------------------------------------------------------------
# concrete model classes (reference class-name parity)
# ---------------------------------------------------------------------------

@MODEL_REGISTRY.register()
class HyperpriorModel(BaseModel):
    """Mean-scale hyperprior: the generic codec (``models/codec.py``)."""


@MODEL_REGISTRY.register()
class HyperpriorCharmModel(BaseModel):
    use_charm = True


class _RateMixin:
    def __init__(self, opt, device=None):
        if opt.subnet.encoder.rate_level != opt.subnet.decoder.rate_level:
            raise ValueError("encoder and decoder rate_level differ")
        self.rate_level = opt.subnet.encoder.rate_level
        super().__init__(opt, device)


@MODEL_REGISTRY.register()
class InterpCaHyperpriorModel(_RateMixin, BaseModel):
    use_rate = True


@MODEL_REGISTRY.register()
class InterpCaHyperpriorCharmModel(_RateMixin, BaseModel):
    use_rate = True
    use_charm = True


class _BetaMixin(_RateMixin):
    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.max_beta: float = opt.subnet.decoder.max_beta


@MODEL_REGISTRY.register()
class BetaCondInterpCaHyperpriorModel(_BetaMixin, BaseModel):
    use_rate = True
    use_beta = True


@MODEL_REGISTRY.register()
class BetaCondInterpCaHyperpriorCharmModel(_BetaMixin, BaseModel):
    use_rate = True
    use_beta = True
    use_charm = True

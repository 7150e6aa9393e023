"""Image helpers: range conversion, reflect pad / crop (NHWC or HWC), PSNR
(uint8-rounded) and MS-SSIM, and image I/O, with the JAX package's exact
formulas (its own copy of ``crdr_tpu/utils/img_utils.py``).

The JAX package reads and writes images through cv2 and PIL, which the GPU
machines the port runs on do not have.  The port reads a file as
``cv2.imread`` does and a request body as PIL's ``convert("RGB")`` does,
each by its leading bytes and not its suffix (cv2 picks its decoder by
content, so a WebP named ``*.jpg`` is a WebP to the JAX package's globs
too): PNG (``utils/png.py``), JPEG (``utils/jpeg.py``), BMP
(``utils/bmp.py``), WebP (``utils/webp.py``), GIF (``utils/gif.py``), PNM
and PFM (``utils/pnm.py``), TIFF (``utils/tiff.py``), JPEG 2000 (a JP2
file or a bare codestream, ``utils/jpeg2000.py``) and Sun raster
(``utils/sunras.py``), each reader with the rules of both oracles, and
Radiance HDR (``utils/hdr.py``) on the file path only (PIL does not open
it).  Where the oracle returns None or raises, the
port raises a ``ValueError`` naming the source and the reason.  It writes
PNG, and JPEG and BMP byte-equal to ``cv2.imwrite``.
"""

from __future__ import annotations

import os
from typing import Tuple, Union

import numpy as np

import torch
import torch.nn.functional as F

from .bmp import BMP_MAGIC, decode_bmp, encode_bmp  # noqa: F401
from .device import resolve_device
from .gif import GIF_MAGICS, decode_gif
from .hdr import decode_hdr, is_hdr
from .jpeg import JPEG_MAGIC, decode_jpeg, encode_jpeg
from .jpeg2000 import decode_jpeg2000, is_jpeg2000
from .png import (PNG_SIGNATURE, decode_png, encode_png,  # noqa: F401
                  read_png, write_png)
from .pnm import decode_pnm, is_pnm
from .sunras import decode_sunras, is_sunras
from .tiff import decode_tiff, is_tiff
from .webp import decode_webp, is_webp

# the formats told apart by their leading bytes: (test, reader)
FORMATS = ((lambda d: d.startswith(PNG_SIGNATURE), decode_png),
           (lambda d: d.startswith(JPEG_MAGIC), decode_jpeg),
           (lambda d: d.startswith(BMP_MAGIC), decode_bmp),
           (is_webp, decode_webp),
           (lambda d: d[:6] in GIF_MAGICS, decode_gif),
           (is_pnm, decode_pnm),
           (is_tiff, decode_tiff),
           (is_jpeg2000, decode_jpeg2000),
           (is_sunras, decode_sunras),
           (is_hdr, decode_hdr))

# ---------------------------------------------------------------------------
# range conversion
# ---------------------------------------------------------------------------


def tensor_to_uint8(img) -> np.ndarray:
    """[-1,1] float NHWC/HWC -> uint8 [0,255]: ``(img + 1) / 2 * 255`` in
    float64, rounded (the reference's img_utils.py:102-132)."""
    arr = np.asarray(img, dtype=np.float64)
    arr = (arr + 1.0) / 2.0 * 255.0
    return np.clip(np.round(arr), 0, 255).astype(np.uint8)


def uint8_to_tensor(arr: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (ToTensor + Normalize(0.5, 0.5))."""
    return (arr.astype(np.float32) / 255.0 - 0.5) * 2.0


def pad_image(x: np.ndarray, stride: int) -> np.ndarray:
    """Reflect-pad NHWC (or HWC) on bottom/right to multiples of ``stride``."""
    h_axis = x.ndim - 3
    H, W = x.shape[h_axis], x.shape[h_axis + 1]
    pad_h = (-H) % stride
    pad_w = (-W) % stride
    if pad_h == 0 and pad_w == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[h_axis] = (0, pad_h)
    pads[h_axis + 1] = (0, pad_w)
    return np.pad(x, pads, mode="reflect")


def crop_image(x, H: int, W: int):
    """Crop NHWC (or HWC) back to (H, W)."""
    if x.ndim == 4:
        return x[:, :H, :W, :]
    return x[:H, :W, :]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def calc_psnr(real, fake, max_val: float = 255.0) -> float:
    """PSNR over uint8-rounded pixels, in float64 (reference semantics)."""
    r = tensor_to_uint8(real).astype(np.float64)
    f = tensor_to_uint8(fake).astype(np.float64)
    mse = np.mean((r - f) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(max_val) - 10 * np.log10(mse))


_MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int, sigma: float, like: torch.Tensor
                     ) -> torch.Tensor:
    coords = torch.arange(size, dtype=like.dtype, device=like.device) \
        - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _gaussian_blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter on NCHW, depthwise."""
    c = x.shape[1]
    x = F.conv2d(x, win.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _ssim_per_channel(x: torch.Tensor, y: torch.Tensor, win: torch.Tensor,
                      data_range: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _gaussian_blur(x, win)
    mu_y = _gaussian_blur(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _gaussian_blur(x * x, win) - mu_xx
    sigma_y = _gaussian_blur(y * y, win) - mu_yy
    sigma_xy = _gaussian_blur(x * y, win) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim.mean(dim=(2, 3)), cs.mean(dim=(2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5) -> torch.Tensor:
    """MS-SSIM of NCHW images in [0, data_range], in their dtype: [N].  5
    scales with the standard weights; images too small for 5 (min side <=
    (win_size - 1) * 2^4) use as many as fit, the weights renormalized.
    Between scales an odd side is edge-padded, then 2x2 averaged.  TF32 is
    off inside: reduced-precision blurs make the variance estimates
    inconsistent enough that SSIM / CS (<= 1 for real inputs) overshoot 1."""
    min_side = min(x.shape[2], x.shape[3])
    levels = 1
    while levels < 5 and (min_side // (2 ** levels)) >= win_size:
        levels += 1
    weights = torch.tensor(_MS_SSIM_WEIGHTS[:levels], dtype=x.dtype,
                           device=x.device)
    weights = weights / torch.sum(weights)
    win = _gaussian_window(win_size, win_sigma, x)
    mcs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=False):
        for i in range(levels):
            ssim_val, cs = _ssim_per_channel(x, y, win, data_range)
            if i < levels - 1:
                mcs.append(torch.clamp(cs, min=0.0))
                pad = (0, x.shape[3] % 2, 0, x.shape[2] % 2)
                if any(pad):
                    x = F.pad(x, pad, mode="replicate")
                    y = F.pad(y, pad, mode="replicate")
                x = F.avg_pool2d(x, 2)
                y = F.avg_pool2d(y, 2)
    stack = torch.stack(mcs + [torch.clamp(ssim_val, min=0.0)])  # [L, N, C]
    return torch.prod(stack ** weights[:, None, None], dim=0).mean(dim=-1)


def calc_ms_ssim(real, fake, device: Union[str, torch.device, None] = None
                 ) -> float:
    """MS-SSIM of [-1,1] NHWC (or HWC) images, taken to [0,1] (reference
    img_utils.py:135-162), averaged over the batch; computed on ``device``
    (the GPU unless the caller passes ``"cpu"``) in float64.  In f32 the
    variances E[x^2] - E[x]^2 of smooth images cancel to a few 1e-6 of
    MS-SSIM (the JAX package's f32 value is that far from float64's), which
    is the size of the differences the metric is read for."""
    dev = resolve_device(device)
    r, f = (torch.from_numpy(np.asarray(a, np.float64)).to(dev)
            for a in (real, fake))
    if r.dim() == 3:
        r, f = r[None], f[None]
    r, f = ((t + 1.0) / 2.0 for t in (r, f))
    return float(ms_ssim(r.permute(0, 3, 1, 2), f.permute(0, 3, 1, 2)).mean())


# ---------------------------------------------------------------------------
# image I/O (utils/png.py, jpeg.py, bmp.py, webp.py, gif.py, pnm.py,
# tiff.py, jpeg2000.py, sunras.py, hdr.py; no cv2, no PIL)
# ---------------------------------------------------------------------------

def decode_image(data: bytes, name: str = "image data",
                 file_path: bool = True) -> np.ndarray:
    """Image bytes (told apart by their leading bytes, not by a suffix)
    -> uint8 [H, W, 3] RGB: a PNG, JPEG, BMP, WebP, GIF, PNM, TIFF,
    JPEG 2000, Sun raster or Radiance HDR file as ``cv2.imread`` reads it
    or, with ``file_path`` False, a request body (but Radiance HDR) as
    PIL's ``convert("RGB")`` reads it (module doc).  Where the
    oracle returns None or raises, this raises a ``ValueError`` naming
    ``name`` and the reason."""
    for test, decode in FORMATS:
        if test(data):
            return decode(data, name, file_path=file_path)
    raise ValueError(f"{name}: not a PNG, JPEG, BMP, WebP, GIF, PNM, TIFF, "
                     "JPEG 2000, Sun raster or Radiance HDR file")


def read_image(path: str) -> np.ndarray:
    """An image file -> uint8 [H, W, 3] RGB, as ``cv2.imread`` reads it
    (``decode_image``); errors name the path."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def imread(path: str) -> np.ndarray:
    """Read an image file to [-1,1] float32 HWC (RGB), as the JAX
    package's ``imread`` (``cv2.imread``) reads it."""
    return uint8_to_tensor(read_image(path))


def imwrite(path: str, img) -> None:
    """Write a [-1,1] float image (HWC or 1HWC) by its extension: ``.png``
    as an RGB PNG, ``.jpg`` / ``.jpeg`` and ``.bmp`` as ``cv2.imwrite``
    writes them at its defaults, byte for byte (the JAX package's
    ``imwrite``); another extension raises."""
    ext = os.path.splitext(path)[1].lower()
    encode = {".png": encode_png, ".jpg": encode_jpeg, ".jpeg": encode_jpeg,
              ".bmp": encode_bmp}.get(ext)
    if encode is None:
        raise ValueError(f"{path}: the port writes .png, .jpg, .jpeg and "
                         ".bmp")
    arr = np.asarray(img)
    if arr.ndim == 4:
        arr = arr[0]
    data = encode(tensor_to_uint8(arr))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)

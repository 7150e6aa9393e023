"""Image helpers: range conversion, reflect pad / crop (NHWC or HWC), PSNR
(uint8-rounded) and MS-SSIM, and 8-bit PNG I/O, with the JAX package's exact
formulas (its own copy of ``crdr_tpu/utils/img_utils.py``).

The JAX package reads and writes images through cv2, which the GPU machines
the port runs on do not have (nor PIL): the port reads and writes 8-bit PNG
itself, through the standard library's ``zlib``.  A JPEG raises.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple, Union

import numpy as np

import torch
import torch.nn.functional as F

from .device import resolve_device

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
# 8-bit PNG I/O (stdlib zlib; no cv2, no PIL)
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # gray, RGB, gray+alpha, RGBA


def _png_chunks(data: bytes, path: str):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str
              ) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) of
    ``raw`` (h rows of a filter byte + ``stride`` bytes)."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data of {len(raw)} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum mod 256 along each channel
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) \
                .astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average / Paeth: serial along the row
            cur_b, up, filt = bytearray(stride), prev.tolist(), line.tolist()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur_b[i] = (filt[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[r] = cur
        prev = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG (gray, gray+alpha, RGB or RGBA) ->
    uint8 [H, W, 3] RGB: alpha dropped, gray expanded.  Chunk CRCs are
    checked; other bit depths, palettes and interlacing raise."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray / RGB / "
                         f"RGBA PNG is read (bit depth {depth}, color type "
                         f"{color}, interlace {interlace})")
    ch = _PNG_CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch, path)
    img = img.reshape(h, w, ch)
    if ch <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W, 3] RGB -> an 8-bit RGB PNG (row filter 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body \
            + struct.pack(">I", zlib.crc32(kind + body))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _check_png(path: str) -> None:
    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: the port reads and writes PNG only (no "
                         "JPEG codec is available to it)")


def imread(path: str) -> np.ndarray:
    """Read a PNG to [-1,1] float32 HWC (RGB)."""
    _check_png(path)
    return uint8_to_tensor(read_png(path))


def imwrite(path: str, img) -> None:
    """Write a [-1,1] float image (HWC or 1HWC) as an RGB PNG."""
    _check_png(path)
    arr = np.asarray(img)
    if arr.ndim == 4:
        arr = arr[0]
    write_png(path, tensor_to_uint8(arr))

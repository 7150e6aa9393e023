"""K3: GDN / inverse GDN — CUDA kernel, its plain twin, the wrapper.

Replaces the Pallas TPU kernel ``crdr_tpu/ops/pallas_gdn.py::pallas_gdn``:
``out = x * (beta + (x * x) . gamma^T)^(-1/2)``, or ``^(+1/2)`` for the
inverse, with ``gamma`` stored ``[C_out, C_in]`` (the torch conv1x1 layout)
and the product accumulated in f32.  Tensors here are NCHW.

* ``gdn`` is the wrapper ``nn.norm.GDN`` calls.  On a CUDA tensor it
  launches ``csrc/gdn.cu`` (built with nvcc for sm_90a into
  ``build/crdr_tpu_torch/`` at first use, loaded with ctypes) or raises: for
  a dtype other than float32, a non-contiguous ``x``, or a channel count the
  kernel's shared-memory plan does not take.  It never falls back to the
  twin.  On a CPU tensor it runs ``gdn_plain``.  ``gdn.launches`` counts
  kernel launches.
* ``gdn_plain`` is the plain PyTorch version: ``gamma`` as a 1x1
  convolution of ``x * x`` plus ``beta`` (TF32 off), then ``rsqrt`` /
  ``sqrt`` times ``x``.

Inference only: the JAX package has no backward kernel for GDN either.  The
source note in the .cu file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.device import build_library, nvcc_command, package_path

Tensor = torch.Tensor

_SRC = package_path("csrc", "gdn.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# the shared-memory plan: the [C, 64] f32 tile of x^2 plus a [32, C + 4]
# chunk of gamma per block, and C / 16 output channels per thread in float4s
KERNEL_CHANNELS = (64, 128, 192, 256)


def build() -> str:
    """Compile the kernel library (no-op when up to date); the compiler's
    register / shared-memory report is kept beside it as ``.log``."""
    return build_library("crdr_gdn", [_SRC], nvcc_command(_SRC))


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.crdr_gdn.restype = i
                lib.crdr_gdn.argtypes = [p, p, p, p, i, i, i, i, i, p]
                _lib = lib
    return _lib


def gdn_plain(x: Tensor, beta: Tensor, gamma: Tensor,
              inverse: bool = False) -> Tensor:
    """x [N, C, H, W]; beta [C]; gamma [C_out, C_in] -> [N, C, H, W]."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=False):
        norm = F.conv2d(x * x, gamma[:, :, None, None], beta)
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


def gdn(x: Tensor, beta: Tensor, gamma: Tensor,
        inverse: bool = False) -> Tensor:
    """GDN of NCHW ``x`` with the reparameterized ``beta`` [C] and ``gamma``
    [C_out, C_in]; the kernel on the card, the plain twin on the CPU."""
    if x.device.type == "cpu":
        return gdn_plain(x, beta, gamma, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"gdn: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"gdn: x must be NCHW, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if x.dtype != torch.float32:
        raise ValueError(f"gdn: the kernel takes float32, got {x.dtype} "
                         "(transform_dtype: bfloat16 is not ported for the "
                         "GDN families)")
    if not x.is_contiguous():
        raise ValueError("gdn: x must be contiguous NCHW")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"gdn: {c} channels; the kernel takes "
                         f"{KERNEL_CHANNELS}")
    for t, shape in ((beta, (c,)), (gamma, (c, c))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(
                f"gdn: expected float32 {shape} contiguous on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if n == 0 or h * w == 0:
        return torch.empty_like(x)
    out = torch.empty_like(x)
    p = h * w
    vec = p % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        rc = _get_lib().crdr_gdn(
            x.data_ptr(), beta.data_ptr(), gamma.data_ptr(), out.data_ptr(),
            n, c, p, int(inverse), int(vec),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gdn: kernel launch failed (cudaError {rc})")
    gdn.launches += 1
    return out


gdn.launches = 0

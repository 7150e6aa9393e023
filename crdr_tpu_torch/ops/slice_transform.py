"""K1: the fused Charm SliceTransform — CUDA kernel, its plain twin, the wrapper.

Replaces the Pallas TPU kernel ``crdr_tpu/ops/pallas_slice_transform.py::
pallas_slice_transform``.  A SliceTransform is conv5x5 -> relu -> conv5x5 ->
relu -> conv3x3 on the [N, H/16, W/16, Cin] latent, with bf16 operands, f32
accumulation, the intermediates rounded to bf16 after the ReLU, and an f32
output (the contract of ``_fused_kernel`` / ``slice_transform_reference``).

* ``slice_transform`` is the wrapper the codec path calls.  On a CUDA tensor
  it launches ``csrc/slice_transform.cu`` (built with nvcc for sm_90a into
  ``build/crdr_tpu_torch/`` at first use, loaded with ctypes) or raises; it
  never falls back.  On a CPU tensor it runs ``slice_transform_plain``.
  ``slice_transform.launches`` counts kernel launches.
* ``slice_transform_plain`` is the plain PyTorch version: bf16-rounded
  operands, f32 convolutions (TF32 off), bf16 rounding after each ReLU.

The source note in the .cu file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.device import build_library, nvcc_command, package_path

_SRC = package_path("csrc", "slice_transform.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# JAX's VMEM gate (pallas_slice_transform.py:145), kept so the port computes
# the same function as the reference in every configuration: larger latents
# take the plain f32 convolutions there, and here.
_MAX_POSITIONS = 64 * 96


def fits_fused(h: int, w: int) -> bool:
    return h * w <= _MAX_POSITIONS


def build() -> str:
    """Compile the kernel library (no-op when up to date); the compiler's
    register / shared-memory report is kept beside it as ``.log``."""
    return build_library("crdr_slice_transform", [_SRC], nvcc_command(_SRC))


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.crdr_slice_transform.restype = i
                lib.crdr_slice_transform.argtypes = [
                    p, i, i, i, i, p, p, i, p, p, i, p, p, i, i, p, p, p, p, p]
                _lib = lib
    return _lib


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               pad: int) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC conv + bias (f32, per image: the result must
    not depend on the batch size)."""
    wk = w.permute(3, 2, 0, 1)
    outs = [F.conv2d(xi.permute(0, 3, 1, 2), wk, b, padding=pad)
            for xi in x.split(1)]
    return torch.cat(outs).permute(0, 2, 3, 1)


def slice_transform_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor, w4: torch.Tensor,
                          b4: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, Cin]; w* HWIO [k, k, Ci, Co]; b* [Co].  -> [N, H, W, Co] f32."""
    f32, bf = torch.float32, torch.bfloat16

    def conv(v, w, b, pad):
        return _conv_nhwc(v.to(bf).to(f32), w.to(bf).to(f32), b.to(f32), pad)

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=False):
        h = torch.relu(conv(x, w0, b0, 2)).to(bf)
        h = torch.relu(conv(h, w2, b2, 2)).to(bf)
        return conv(h, w4, b4, 1).contiguous()


def slice_transform(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, w4: torch.Tensor,
                    b4: torch.Tensor, idx: int) -> torch.Tensor:
    """SliceTransform of slice ``idx`` of the packed stacks.

    x [N, H, W, Cin] f32; w0 [S, 5, 5, Cin, C0], w2 [S, 5, 5, C0, C1],
    w4 [S, 3, 3, C1, Cout] (bf16 for the kernel); b* [S, C] f32.
    Returns [N, H, W, Cout] f32."""
    if x.device.type == "cpu":
        return slice_transform_plain(x, w0[idx], b0[idx], w2[idx], b2[idx],
                                     w4[idx], b4[idx])
    if x.device.type != "cuda":
        raise ValueError(f"slice_transform: unsupported device {x.device}")
    n, h, w, cin = x.shape
    S, c0, c1, cout = w0.shape[0], w0.shape[-1], w2.shape[-1], w4.shape[-1]
    shapes = [(w0, (S, 5, 5, cin, c0)), (w2, (S, 5, 5, c0, c1)),
              (w4, (S, 3, 3, c1, cout)), (b0, (S, c0)), (b2, (S, c1)),
              (b4, (S, cout))]
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("slice_transform: x must be contiguous float32")
    for t, shape in shapes:
        want = torch.bfloat16 if t.dim() == 5 else torch.float32
        if tuple(t.shape) != shape or t.dtype != want \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(
                f"slice_transform: expected {want} {shape} contiguous on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if any(c % 8 for c in (cin, c0, c1, cout)):
        raise ValueError("slice_transform: channel counts must be multiples "
                         f"of 8, got {(cin, c0, c1, cout)}")
    if any(t.data_ptr() % 16 for t in (x, w0, w2, w4)):
        raise ValueError("slice_transform: tensors must be 16-byte aligned")
    if not 0 <= idx < S:
        raise IndexError(f"slice_transform: slice {idx} of {S}")
    xb = torch.empty((n, h, w, cin), dtype=torch.bfloat16, device=x.device)
    h0 = torch.empty((n, h, w, c0), dtype=torch.bfloat16, device=x.device)
    h1 = torch.empty((n, h, w, c1), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _get_lib().crdr_slice_transform(
            x.data_ptr(), n, h, w, cin, w0.data_ptr(), b0.data_ptr(), c0,
            w2.data_ptr(), b2.data_ptr(), c1, w4.data_ptr(), b4.data_ptr(),
            cout, int(idx), xb.data_ptr(), h0.data_ptr(), h1.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slice_transform: kernel launch failed "
                           f"(cudaError {rc})")
    slice_transform.launches += 1
    return out


slice_transform.launches = 0

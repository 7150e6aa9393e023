"""K3: GDN / inverse GDN — CUDA kernel, its plain twin, the wrapper.

Replaces the Pallas TPU kernel ``crdr_tpu/ops/pallas_gdn.py::pallas_gdn``:
``out = x * (beta + (x * x) . gamma^T)^(-1/2)``, or ``^(+1/2)`` for the
inverse, with ``gamma`` stored ``[C_out, C_in]`` (the torch conv1x1 layout)
and the product accumulated in f32.  Tensors here are NCHW.

* ``gdn`` is the wrapper ``nn.norm.GDN`` calls, the registered op
  ``crdr::gdn`` (one node of an exported program).  On a CUDA tensor its
  CUDA implementation launches ``csrc/gdn.cu`` (built with nvcc for sm_90a into
  ``build/crdr_tpu_torch/`` at first use, loaded with ctypes), handing it
  ``gamma^T``, or raises: for a dtype other than float32, a non-contiguous
  ``x``, or a channel count the kernel's tile plan does not take.  It never
  falls back to the twin.  On a CPU tensor its CPU implementation runs
  ``gdn_plain``.
  ``gdn.launches`` counts kernel launches.
* ``gdn_plain`` is the plain PyTorch version: ``gamma`` as a 1x1
  convolution of ``x * x`` plus ``beta`` (TF32 off), then ``rsqrt`` /
  ``sqrt`` times ``x``.

The op has a gradient (``register_autograd``), so its output has a
``grad_fn`` whenever an input needs one: the forward is the kernel (the
twin on the CPU), the backward the op ``crdr::gdn_backward``: autograd of
``gdn_plain`` with TF32 off (the JAX package has no backward kernel for GDN
either: ``pallas_gdn`` has no custom VJP).  The
source note in the .cu file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import (build_library, count_launch, nvcc_command,
                            package_path)

Tensor = torch.Tensor

_SRC = package_path("csrc", "gdn.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# the tile plan: 64 pixels a block, C / 16 output channels x 4 pixels a
# thread (gamma^T read in float4s), 16-row chunks of gamma^T and x
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
                lib.crdr_gdn_occupancy.restype = i
                lib.crdr_gdn_occupancy.argtypes = [i, p]
                _lib = lib
    return _lib


def gdn_plain(x: Tensor, beta: Tensor, gamma: Tensor,
              inverse: bool = False) -> Tensor:
    """x [N, C, H, W]; beta [C]; gamma [C_out, C_in] -> [N, C, H, W].

    TF32 is off for the forward's convolution only: autograd runs the
    backward's convolutions later, outside these flags, so on the card they
    use TF32 (PyTorch's cuDNN default) unless the caller turns it off (the
    op's backward, ``crdr::gdn_backward``, runs with TF32 off)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=False):
        norm = F.conv2d(x * x, gamma[:, :, None, None], beta)
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


def occupancy(c: int) -> dict:
    """The kernel's plan at ``c`` channels on the current device: blocks
    resident an SM, pixels a block, shared-memory bytes a block."""
    res = (ctypes.c_int * 3)()
    rc = _get_lib().crdr_gdn_occupancy(c, ctypes.addressof(res))
    if rc != 0:
        raise RuntimeError(f"gdn: occupancy query failed (cudaError {rc})")
    return {"blocks_per_sm": res[0], "tile_pixels": res[1],
            "smem_bytes": res[2]}


@torch.library.custom_op("crdr::gdn", mutates_args=(), device_types="cuda")
def _gdn_op(x: Tensor, beta: Tensor, gamma: Tensor, inverse: bool) -> Tensor:
    """The kernel: the checks, one counted launch (or a raise)."""
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
    gamma_t = gamma.t().contiguous()  # [C_in, C_out]: chunks of whole rows
    p = h * w
    vec = p % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        rc = _get_lib().crdr_gdn(
            x.data_ptr(), beta.data_ptr(), gamma_t.data_ptr(), out.data_ptr(),
            n, c, p, int(inverse), int(vec),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gdn: kernel launch failed (cudaError {rc})")
    count_launch(gdn)
    return out


@_gdn_op.register_kernel("cpu")
def _gdn_cpu(x, beta, gamma, inverse):
    return gdn_plain(x, beta, gamma, inverse)


@_gdn_op.register_fake
def _gdn_fake(x, beta, gamma, inverse):
    return torch.empty_like(x)


def _gdn_setup_context(ctx, inputs, output):
    x, beta, gamma, inverse = inputs
    ctx.save_for_backward(x, beta, gamma)
    ctx.inverse = inverse


@torch.library.custom_op("crdr::gdn_backward", mutates_args=())
def _gdn_backward_op(grad: Tensor, x: Tensor, beta: Tensor, gamma: Tensor,
                     inverse: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """The gradients of x, beta and gamma: autograd of ``gdn_plain`` with
    TF32 off (the JAX package has no backward kernel either).  An op of its
    own, so that a traced graph (``torch.compile``) keeps it whole: the TF32
    setting is read when the convolutions run, not traced."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=False):
        _, vjp = torch.func.vjp(
            lambda a, b, c: gdn_plain(a, b, c, inverse), x, beta, gamma)
        return vjp(grad)


@_gdn_backward_op.register_fake
def _gdn_backward_fake(grad, x, beta, gamma, inverse):
    return (torch.empty_like(x), torch.empty_like(beta),
            torch.empty_like(gamma))


def _gdn_backward(ctx, grad):
    grads = torch.ops.crdr.gdn_backward(grad, *ctx.saved_tensors,
                                        ctx.inverse)
    return tuple(g if r else None for g, r in
                 zip(grads, ctx.needs_input_grad[:3])) + (None,)


_gdn_op.register_autograd(_gdn_backward, setup_context=_gdn_setup_context)


def gdn(x: Tensor, beta: Tensor, gamma: Tensor,
        inverse: bool = False) -> Tensor:
    """GDN of NCHW ``x`` with the reparameterized ``beta`` [C] and ``gamma``
    [C_out, C_in]: the op ``crdr::gdn``, the kernel on the card, the plain
    twin on the CPU, and a ``grad_fn`` whenever an input needs a
    gradient."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gdn: unsupported device {x.device}")
    return torch.ops.crdr.gdn(x, beta, gamma, bool(inverse))


gdn.launches = 0

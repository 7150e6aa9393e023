"""K3: GDN / inverse GDN — CUDA kernel, its plain twin, the wrapper.

Replaces the Pallas TPU kernel ``crdr_tpu/ops/pallas_gdn.py::pallas_gdn``:
``out = x * (beta + (x * x) . gamma^T)^(-1/2)``, or ``^(+1/2)`` for the
inverse, with ``gamma`` stored ``[C_out, C_in]`` (the torch conv1x1 layout)
and the product accumulated in f32.  Tensors here are NCHW.

* ``gdn`` is the wrapper ``nn.norm.GDN`` calls, the registered op
  ``crdr::gdn`` (one node of an exported program).  ``x``, ``beta`` and
  ``gamma`` share one dtype (a mix raises, naming the three).  On a CUDA
  tensor its CUDA implementation launches ``csrc/gdn.cu`` (built with nvcc
  for sm_90a into ``build/crdr_tpu_torch/`` at first use, loaded with
  ctypes): its f32 mode, handed ``gamma^T`` (a copy a call), or, for
  bfloat16 tensors (``transform_dtype: bfloat16``), its bf16 mode, handed
  ``gamma`` and ``beta`` as they lie (the product on the tensor cores); or
  raises: for another dtype, a non-contiguous ``x``, or a channel count the
  kernel's tile plan does not take.  It never falls back to the twin.  On a
  CPU tensor its CPU implementation runs ``gdn_plain``.
  ``gdn.launches`` counts kernel launches, of both modes.
* ``gdn_plain`` is the plain PyTorch version: ``gamma`` as a 1x1
  convolution of ``x * x`` plus ``beta`` (TF32 off), then ``rsqrt`` /
  ``sqrt`` times ``x``.  In bfloat16 it is the JAX package's bf16 composite
  (``crdr_tpu/nn/norm.py``: JAX's Pallas kernel cannot store bf16, so its
  bf16 GDN is the einsum path), each step rounded to bf16: ``x * x``; the
  1x1 convolution without ``beta`` (f32 sums of the exact products, bf16
  out); ``+ beta``; the square root or its reciprocal, correctly rounded
  in f32 (as XLA's bf16 ``rsqrt``; ``torch.rsqrt`` of a bf16 tensor rounds
  twice on the CPU); ``x *`` that.  ``bf16_sum`` and ``bf16_tail`` are
  its two halves, and ``bf16_unexplained`` holds a bf16 output to the
  composite whatever order its sum took (the checks on the card).

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
# the tile plans: f32, 64 pixels a block, C / 16 output channels x 4 pixels
# a thread (gamma^T read in float4s), 16-row chunks of gamma^T and x; bf16,
# 64-pixel TMA tiles of all C channels, m16n8k16 warp tiles of C / 64 x 32
# (a TMA box holds at most 256 rows)
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
                lib.crdr_gdn_bf16.restype = i
                lib.crdr_gdn_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p]
                lib.crdr_gdn_occupancy.restype = i
                lib.crdr_gdn_occupancy.argtypes = [i, i, p]
                _lib = lib
    return _lib


def gdn_plain(x: Tensor, beta: Tensor, gamma: Tensor,
              inverse: bool = False) -> Tensor:
    """x [N, C, H, W]; beta [C]; gamma [C_out, C_in] -> [N, C, H, W].

    TF32 is off for the forward's convolution only: autograd runs the
    backward's convolutions later, outside these flags, so on the card they
    use TF32 (PyTorch's cuDNN default) unless the caller turns it off (the
    op's backward, ``crdr::gdn_backward``, runs with TF32 off).  bfloat16
    tensors take the bf16 composite of the module doc."""
    if x.dtype == torch.bfloat16:
        return _gdn_plain_bf16(x, beta, gamma, inverse)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=False):
        norm = F.conv2d(x * x, gamma[:, :, None, None], beta)
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


def _gdn_plain_bf16(x: Tensor, beta: Tensor, gamma: Tensor,
                    inverse: bool) -> Tensor:
    """JAX's bf16 composite, each step rounded to bf16 (module doc)."""
    return bf16_tail(x, beta, bf16_sum(x, gamma), inverse)


def bf16_sum(x: Tensor, gamma: Tensor) -> Tensor:
    """The bf16 composite's ``gamma . x^2``, rounded to bf16: the product
    of the bf16 ``x * x`` and ``gamma`` as the f32 convolution of their
    exact f32 copies (f32 sums, one rounding to bf16), not fused with
    ``beta``: JAX rounds the sum before the add.  The one step whose result
    depends on the order of a sum."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=False):
        norm = F.conv2d((x * x).float(), gamma.float()[:, :, None, None])
    return norm.to(torch.bfloat16)


def bf16_tail(x: Tensor, beta: Tensor, norm: Tensor,
              inverse: bool) -> Tensor:
    """The bf16 composite after its sum ``norm`` (bf16): ``+ beta``, the
    square root or its reciprocal, ``x *`` that, each rounded to bf16."""
    norm = norm + beta[None, :, None, None]
    if inverse:
        root = torch.sqrt(norm.float())
    else:  # f64's 1 / sqrt rounded to f32: f32's correctly rounded rsqrt
        root = torch.reciprocal(torch.sqrt(norm.double())).float()
    return x * root.to(torch.bfloat16)


def bf16_unexplained(out: Tensor, x: Tensor, beta: Tensor, gamma: Tensor,
                     inverse: bool) -> int:
    """How many elements of a bf16 GDN output ``out`` the composite gives
    for no sum within 1 bf16 ulp of ``bf16_sum``'s, every later step
    exact: 0 for K3's bf16 mode, whatever order its f32 sum and the twin's
    take (an f32 sum in another order may round to the neighbouring bf16
    value, which moves the output by up to 2 ulps)."""
    bits = bf16_sum(x, gamma).view(torch.int16)  # the sum is >= 0
    hit = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
    for step in (-1, 0, 1):
        near = (bits + step).clamp(min=0).view(torch.bfloat16)
        hit |= bf16_tail(x, beta, near, inverse) == out
    return int((~hit).sum())


def occupancy(c: int, bf16: bool = False) -> dict:
    """The kernel's plan at ``c`` channels in its f32 or bf16 mode on the
    current device: blocks resident an SM, pixels a tile (a block's in the
    f32 mode), shared-memory bytes a block."""
    res = (ctypes.c_int * 3)()
    rc = _get_lib().crdr_gdn_occupancy(c, int(bf16), ctypes.addressof(res))
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gdn: the kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gdn: x must be contiguous NCHW")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"gdn: {c} channels; the kernel takes "
                         f"{KERNEL_CHANNELS}")
    for t, shape in ((beta, (c,)), (gamma, (c, c))):
        if tuple(t.shape) != shape or t.dtype != x.dtype \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(
                f"gdn: expected {x.dtype} {shape} contiguous on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n == 0 or h * w == 0:
        return torch.empty_like(x)
    out = torch.empty_like(x)
    p = h * w
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # vector copies: 16 bytes of pixels (f32 4, bf16 8), aligned
    vec = p % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:  # gamma [C_out, C_in] as it lies
            if gamma.data_ptr() % 16:
                gamma = gamma.clone()
            rc = _get_lib().crdr_gdn_bf16(
                x.data_ptr(), beta.data_ptr(), gamma.data_ptr(),
                out.data_ptr(), n, c, p, int(inverse), int(vec), stream)
        else:  # [C_in, C_out]: chunks of whole rows
            gamma_t = gamma.t().contiguous()
            rc = _get_lib().crdr_gdn(
                x.data_ptr(), beta.data_ptr(), gamma_t.data_ptr(),
                out.data_ptr(), n, c, p, int(inverse), int(vec), stream)
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
    if not x.dtype == beta.dtype == gamma.dtype:
        raise ValueError(f"gdn: x, beta and gamma must share one dtype, got "
                         f"x {x.dtype}, beta {beta.dtype}, gamma "
                         f"{gamma.dtype}")
    return torch.ops.crdr.gdn(x, beta, gamma, bool(inverse))


gdn.launches = 0

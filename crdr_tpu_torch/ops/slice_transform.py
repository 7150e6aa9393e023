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
* ``conv_plan`` / ``slice_transform_plan`` are the kernel's tiling plan, a
  pure function of (H, W, Cin, Cout, ksize) that takes no batch size: the
  tile shape, the k-steps and their split over a thread-block cluster.  The
  wrapper passes it to the kernel, so every output's summation order is
  fixed by shape alone.
* ``slice_transform_plain`` is the plain PyTorch version: bf16-rounded
  operands, f32 convolutions (TF32 off; on a GPU im2col products,
  ``_conv_nhwc``), bf16 rounding after each ReLU.

The source note in the .cu file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import (build_library, count_launch, nvcc_command,
                            package_path)

_SRC = package_path("csrc", "slice_transform.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# JAX's VMEM gate (pallas_slice_transform.py:145), kept so the port computes
# the same function as the reference in every configuration: larger latents
# take the plain f32 convolutions there, and here.
_MAX_POSITIONS = 64 * 96


def fits_fused(h: int, w: int) -> bool:
    return h * w <= _MAX_POSITIONS


# ---- the kernel's tiling plan (csrc/slice_transform.cu) --------------------

BK = 64                  # input channels per k-step (one 128-byte TMA row)
BOX_M = 64               # positions of one A box: one wgmma M
TILE_M = 2 * BOX_M       # a block's tile: two boxes, one per consumer
N_INST = (32, 128, 224)   # the kernel's wgmma N instances
MAX_SPLIT = 8            # a portable thread-block cluster
SPLITS = (1, 2, 4, 8)
# The split is the largest that keeps a call at REF_BATCH images within one
# wave of RESIDENT_BLOCKS blocks (one a SM on the H100 SXM's 132 SMs).  Both
# are constants, not properties of the call: the plan, and with it every
# output's summation order, is a function of the shape alone.  REF_BATCH is
# the batch the codec's analysis runs at and chip_smoke.py serves; measured
# at 32x48 (PERF.md), splitting further for batch 1 costs batch 4 more (its
# clusters of 8 run in 3+ waves, and the ranks' partial tiles cross the
# cluster) than it gains at batch 1.
REF_BATCH = 4
RESIDENT_BLOCKS = 132
MIN_STEPS_PER_RANK = 4   # below this a rank's pipeline never fills
PLAN_INTS = 11 + MAX_SPLIT + 1   # as the C entry reads one conv's plan


def conv_plan(h: int, w: int, cin: int, cout: int, ksize: int,
              split: Optional[int] = None) -> Dict:
    """The plan of one conv of the kernel on an [*, h, w, cin] input: a
    function of the shape alone (there is no batch argument).

    A tile is two boxes of ``rb`` rows x ``cw`` columns (64 positions each)
    of one image; ``tiles_x * tiles_y`` tiles cover the image (the grid
    rounds them up to a multiple of ``pair``; the extra tile lies outside the
    image).  The k-steps are (tap, 64-channel chunk), taps outer; k-rank r
    of ``split`` runs steps ``[bounds[r], bounds[r + 1])`` and the ranks'
    partial sums are added in rank order.  A cluster holds the ``split``
    k-ranks of ``pair`` tiles, which share each weight box by multicast.
    ``split`` overrides the default (for measurements).  Raises ValueError
    for a shape the kernel cannot serve."""
    if ksize not in (3, 5):
        raise ValueError(f"conv_plan: ksize {ksize} (3 or 5)")
    if h < 1 or w < 1 or not fits_fused(h, w):
        raise ValueError(f"conv_plan: latent {h}x{w} outside 1.."
                         f"{_MAX_POSITIONS} positions")
    if min(cin, cout) < 8 or cin % 8 or cout % 8:
        raise ValueError("conv_plan: channel counts must be positive "
                         f"multiples of 8, got cin {cin}, cout {cout}")
    if cout > N_INST[-1]:
        raise ValueError(f"conv_plan: cout {cout} > {N_INST[-1]}")
    tiles, cw = None, None
    for c in (64, 32, 16, 8):  # fewest tiles; ties go to the wider box
        t = -(-w // c) * -(-h // (2 * (BOX_M // c)))
        if tiles is None or t < tiles:
            tiles, cw = t, c
    rb = BOX_M // cw
    kchunks = -(-cin // BK)
    ksteps = ksize * ksize * kchunks
    # two tiles share each weight box by multicast where a step's weight
    # boxes outnumber its two A boxes (at 32x48 it speeds up the 224-wide
    # conv and slows the 128- and 32-wide ones: PERF.md)
    n_inst = min(n for n in N_INST if n >= cout)
    pair = 2 if tiles > 1 and -(-n_inst // 64) > 2 else 1
    blocks = -(-tiles // pair) * pair
    if split is None:
        split = 1
        while (split * pair < MAX_SPLIT
               and REF_BATCH * blocks * 2 * split <= RESIDENT_BLOCKS
               and ksteps // (2 * split) >= MIN_STEPS_PER_RANK):
            split *= 2
    if split not in SPLITS or split > ksteps:
        raise ValueError(f"conv_plan: split {split} (one of {SPLITS}, at "
                         f"most {ksteps} k-steps)")
    if split * pair > MAX_SPLIT:
        pair = 1  # a cluster of more blocks is not portable
    return dict(ksize=ksize, cin=cin, cout=cout, n_inst=n_inst, cw=cw, rb=rb,
                tiles_x=-(-w // cw), tiles_y=-(-h // (2 * rb)),
                kchunks=kchunks, split=split, pair=pair,
                bounds=[r * ksteps // split for r in range(split + 1)])


def slice_transform_plan(h: int, w: int, cin: int, c0: int, c1: int,
                         cout: int, splits: Optional[Tuple[int, ...]] = None
                         ) -> List[Dict]:
    """The plans of the three convs (5x5 cin->c0, 5x5 c0->c1, 3x3
    c1->cout); ``splits`` overrides each conv's split."""
    splits = splits or (None, None, None)
    return [conv_plan(h, w, ci, co, k, s) for (ci, co, k), s in zip(
        ((cin, c0, 5), (c0, c1, 5), (c1, cout, 3)), splits)]


def plan_ints(plans: List[Dict]) -> List[int]:
    """The plans as the C entry reads them, PLAN_INTS ints per conv."""
    out = []
    for p in plans:
        out += [p[k] for k in ("ksize", "cin", "cout", "n_inst", "cw", "rb",
                               "tiles_x", "tiles_y", "kchunks", "split",
                               "pair")]
        out += p["bounds"] + [0] * (MAX_SPLIT + 1 - len(p["bounds"]))
    return out


def plan_k_steps(plan: Dict) -> List[List[Tuple[int, int]]]:
    """Each rank's k-steps as (tap, first input channel), in the order the
    kernel sums them."""
    kc = plan["kchunks"]
    b = plan["bounds"]
    return [[(s // kc, (s % kc) * BK) for s in range(b[r], b[r + 1])]
            for r in range(plan["split"])]


def plan_tile_positions(plan: Dict, tile: int) -> List[Tuple[int, int]]:
    """The (y, x) of each of a tile's TILE_M rows, in the kernel's row order
    (some lie outside the image on a ragged edge and are not stored)."""
    ty, tx = divmod(tile, plan["tiles_x"])
    cw, rb = plan["cw"], plan["rb"]
    return [(ty * 2 * rb + (r // BOX_M) * rb + (r % BOX_M) // cw,
             tx * cw + r % cw) for r in range(TILE_M)]


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
                    p, i, i, i, i, p, p, i, p, p, i, p, p, i, i, i, p, p, p,
                    p, p, p]
                lib.crdr_slice_transform_occupancy.restype = i
                lib.crdr_slice_transform_occupancy.argtypes = [i, i, i, i, p,
                                                               p, p]
                if lib.crdr_slice_transform_plan_ints() != PLAN_INTS:
                    raise RuntimeError("slice_transform: the library reads "
                                       "another plan layout")
                _lib = lib
    return _lib


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               pad: int) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC 'same' conv + bias (f32, per image: the
    result must not depend on the batch size).  On a GPU it is an im2col
    product (``unfold``, then one matmul an image; TF32 as the matmul flag
    says), not cuDNN: cuDNN takes the first of its plans whose workspace it
    can allocate, so on a large latent (past K1's gate, where a plan asked
    for tens of GiB) the plan, and the bits of mu, followed the memory free
    at the call, and a decoder could part from its encoder's replay."""
    wk = w.permute(3, 2, 0, 1)
    if x.device.type != "cuda":
        outs = [F.conv2d(xi.permute(0, 3, 1, 2), wk, b, padding=pad)
                for xi in x.split(1)]
        return torch.cat(outs).permute(0, 2, 3, 1)
    _, h, wd, _ = x.shape
    wm = wk.reshape(wk.shape[0], -1)  # unfold's (channel, kh, kw) order
    outs = [torch.addmm(b[:, None], wm, F.unfold(
        xi.permute(0, 3, 1, 2), w.shape[0], padding=pad)[0]).view(
        1, -1, h, wd) for xi in x.split(1)]
    return torch.cat(outs).permute(0, 2, 3, 1)


def slice_transform_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor, w4: torch.Tensor,
                          b4: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, Cin]; w* HWIO [k, k, Ci, Co]; b* [Co].  -> [N, H, W, Co] f32."""
    f32, bf = torch.float32, torch.bfloat16

    def conv(v, w, b, pad):
        return _conv_nhwc(v.to(bf).to(f32), w.to(bf).to(f32), b.to(f32), pad)

    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                         deterministic=True,
                                         allow_tf32=False):
            h = torch.relu(conv(x, w0, b0, 2)).to(bf)
            h = torch.relu(conv(h, w2, b2, 2)).to(bf)
            return conv(h, w4, b4, 1).contiguous()
    finally:
        matmul.allow_tf32 = saved


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
    if any(t.data_ptr() % 16 for t in (x, w0, w2, w4, b0, b2, b4)):
        raise ValueError("slice_transform: tensors must be 16-byte aligned")
    if not 0 <= idx < S:
        raise IndexError(f"slice_transform: slice {idx} of {S}")
    return _launch(x, w0, b0, w2, b2, w4, b4, idx,
                   _default_plan(h, w, cin, c0, c1, cout))


@functools.lru_cache(maxsize=None)
def _default_plan(h: int, w: int, cin: int, c0: int, c1: int,
                  cout: int) -> Tuple[int, ...]:
    return tuple(plan_ints(slice_transform_plan(h, w, cin, c0, c1, cout)))


@functools.lru_cache(maxsize=None)
def _plan_array(plan: Tuple[int, ...]) -> ctypes.Array:
    return (ctypes.c_int * len(plan))(*plan)  # read only by the C entry


def _launch(x, w0, b0, w2, b2, w4, b4, idx: int,
            plan: Tuple[int, ...]) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs with ``plan`` (plan_ints of
    slice_transform_plan at x's shape); raises on any launch error."""
    n, h, w, cin = x.shape
    S, c0, c1, cout = w0.shape[0], w0.shape[-1], w2.shape[-1], w4.shape[-1]
    bf = dict(dtype=torch.bfloat16, device=x.device)
    xp = torch.empty((n, h + 4, w + 4, cin), **bf)  # borders: the kernel
    h0p = torch.empty((n, h + 4, w + 4, c0), **bf)
    h1p = torch.empty((n, h + 2, w + 2, c1), **bf)
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=x.device)
    cplan = _plan_array(plan)
    with torch.cuda.device(x.device):
        rc = _get_lib().crdr_slice_transform(
            x.data_ptr(), n, h, w, cin, w0.data_ptr(), b0.data_ptr(), c0,
            w2.data_ptr(), b2.data_ptr(), c1, w4.data_ptr(), b4.data_ptr(),
            cout, S, int(idx), cplan, xp.data_ptr(), h0p.data_ptr(),
            h1p.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        what = {-1: "the plan does not fit the call",
                -2: "cuTensorMapEncodeTiled failed"}.get(rc, f"cudaError {rc}")
        raise RuntimeError(f"slice_transform: kernel launch failed ({what})")
    count_launch(slice_transform)
    return out


def occupancy(plan: Dict, last: bool) -> Dict[str, int]:
    """Residency of the conv instance that serves ``plan`` on the current
    GPU: blocks per SM, clusters of ``plan['split'] * plan['pair']`` blocks
    resident at once, and dynamic shared memory per block (bytes)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _get_lib().crdr_slice_transform_occupancy(
        plan["n_inst"], int(last), plan["split"], plan["pair"],
        *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"slice_transform: occupancy query failed "
                           f"(cudaError {rc})")
    return dict(zip(("blocks_per_sm", "clusters", "smem_bytes"),
                    (v.value for v in vals)))


slice_transform.launches = 0

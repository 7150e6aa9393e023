"""One image's height split over a mesh (counterpart of
``crdr_tpu/parallel/spatial.py``).

JAX shards the height of an NHWC image over a mesh and lets XLA insert
each convolution's halo exchange.  Eager PyTorch has no partitioner, so
the port uses overlap tiles, which need no exchange at all: each device
takes its block of rows plus a margin on each side that holds the whole
receptive field of its edge rows, runs the transform on that tile, and
keeps its own rows.  Past an image border the tile ends where the image
does, so its padding is the whole image's.  The result equals the
unsplit transform's exactly up to the order of sums (on the CPU the bytes
are equal; on the card cuDNN may pick other algorithms for other shapes).

The margin is computed from the transform, not written down: ``row_halo``
runs it once on a small probe on the CPU under a ``TorchFunctionMode``
that follows, for every tensor, which of its rows depend on rows past the
probe's top and bottom edges, from each operation's own geometry: the
kernel size, stride, padding and dilation of a convolution, the same of a
transposed convolution, reflect / zero padding (HiFiC's 7x7 stem),
pixel-shuffle and nearest up-sampling; the operations known to be
row-local (``_ROW_LOCAL``: elementwise, dtype casts, reductions and joins
that keep the height) carry the rows of their inputs.  An operation that
mixes the whole height (a mean over it, as ``InstanceNorm2D`` takes)
cannot be tiled and raises ``SpatialSplitError``, as does any other
operation on a tracked tensor that the mode does not know (a softmax,
cumulative sum, flip or roll along the height would shift rows without
changing the shape).

The split is on a grid of rows (the latent rows): a transform maps ``a``
input rows to ``b`` output rows per grid row (the analysis 16 -> 1, the
synthesis 1 -> 16), the tiles start and end on the grid, so a strided
convolution sees its grid in a tile as in the whole image.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

Tensor = torch.Tensor
_ATTR = "_crdr_wrong_rows"  # a bool array over dim 2 of an NCHW tensor


class SpatialSplitError(ValueError):
    """A transform that an overlap tile cannot reproduce."""


# ---------------- the rows each operation's output depends on ----------------

def _conv_rows(wrong: np.ndarray, k: int, s: int, p: int, d: int,
               n_out: int) -> np.ndarray:
    """Output row j reads input rows j*s - p + t*d, t < k; a row past either
    edge stands for data of the neighbouring tile."""
    idx = np.arange(n_out)[:, None] * s - p + np.arange(k)[None, :] * d
    outside = (idx < 0) | (idx >= len(wrong))
    return np.any(outside | wrong[np.clip(idx, 0, len(wrong) - 1)], axis=1)


def _conv_transpose_rows(wrong: np.ndarray, k: int, s: int, p: int, d: int,
                         n_out: int) -> np.ndarray:
    """Output row j gathers input rows i with i*s - p + t*d == j."""
    out = np.zeros(n_out, bool)
    for j in range(n_out):
        for t in range(k):
            num = j + p - t * d
            if num % s == 0:
                i = num // s
                if i < 0 or i >= len(wrong) or wrong[i]:
                    out[j] = True
                    break
    return out


def _arg(args, kwargs, i: int, name: str, default):
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


def _pair0(v) -> int:
    """The height component of an int-or-pair convolution argument."""
    if isinstance(v, (tuple, list)):
        return int(v[0])
    if isinstance(v, str):
        raise SpatialSplitError(f"convolution padding {v!r}")
    return int(v)


def _tracked(t) -> Optional[np.ndarray]:
    return getattr(t, _ATTR, None) if isinstance(t, Tensor) else None


def _flat(obj):
    if isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _flat(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _flat(o)
    else:
        yield obj


# Output row i reads row i of the inputs alone: elementwise operations,
# casts and copies; reductions and joins whose output keeps the height (a
# mean over the channels, a concatenation along them: over the height they
# change it, and the tracker raises).
_ROW_LOCAL = frozenset({
    "add", "sub", "mul", "div", "neg", "abs", "pow", "sqrt", "rsqrt", "exp",
    "exp2", "log", "log2", "reciprocal", "square", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "sign", "where", "minimum",
    "maximum", "relu", "leaky_relu", "gelu", "silu", "sigmoid", "tanh",
    "softplus", "__add__", "__radd__", "__iadd__", "__sub__", "__rsub__",
    "__isub__", "__mul__", "__rmul__", "__imul__", "__truediv__",
    "__rtruediv__", "__itruediv__", "__neg__", "__pow__", "__rpow__",
    "__abs__", "add_", "sub_", "mul_", "div_", "clamp_", "relu_", "to",
    "float", "double", "half", "bfloat16", "long", "int", "type_as",
    "contiguous", "clone", "detach", "mean", "var", "std", "sum", "amax",
    "amin", "cat",
})


class _RowTracker(TorchFunctionMode):
    """Follows the dependence of NCHW rows on the rows past a probe's
    edges (module doc)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = [(t, w) for t in _flat((args, kwargs))
                  if (w := _tracked(t)) is not None]
        if not inputs:
            return out
        name = getattr(func, "__name__", str(func))
        x, w = inputs[0]
        if name in ("conv2d", "conv_transpose2d") and x is args[0]:
            k = args[1].shape[2]
            s = _pair0(_arg(args, kwargs, 3, "stride", 1))
            p = _pair0(_arg(args, kwargs, 4, "padding", 0))
            if name == "conv2d":
                d = _pair0(_arg(args, kwargs, 5, "dilation", 1))
                rows = _conv_rows(w, k, s, p, d, out.shape[2])
            else:
                d = _pair0(_arg(args, kwargs, 7, "dilation", 1))
                rows = _conv_transpose_rows(w, k, s, p, d, out.shape[2])
            return self._mark(out, rows)
        if name == "pad" and x is args[0]:
            pad = list(_arg(args, kwargs, 1, "pad", ()))
            top, bottom = (pad[2], pad[3]) if len(pad) >= 4 else (0, 0)
            return self._mark(out, np.concatenate(
                [np.ones(top, bool), w, np.ones(bottom, bool)]))
        if name in ("pixel_shuffle", "interpolate", "upsample_nearest2d"):
            if name == "interpolate" and _arg(
                    args, kwargs, 3, "mode", "nearest") != "nearest":
                raise SpatialSplitError(f"{name} other than nearest")
            r, rem = divmod(out.shape[2], len(w))
            if rem:
                raise SpatialSplitError(f"{name} by a fractional factor")
            return self._mark(out, np.repeat(w, r))
        if not any(isinstance(o, Tensor) for o in _flat(out)):
            return out  # a size, a dtype: no rows
        if name not in _ROW_LOCAL:
            raise SpatialSplitError(
                f"{name} on the image's rows is not known to keep each row "
                "to itself; an overlap tile cannot be shown to reproduce it")
        for o in _flat(out):
            if not isinstance(o, Tensor):
                continue
            same = [w_ for t, w_ in inputs if o.dim() == t.dim() == 4
                    and o.shape[2] == len(w_)]
            if same:
                self._mark(o, np.logical_or.reduce(same))
            elif o.dim() != 4 or any(len(w_) > 1 for _, w_ in inputs):
                raise SpatialSplitError(
                    f"{name} mixes or reshapes the image height (an "
                    f"output of shape {tuple(o.shape)} from rows "
                    f"{[len(w_) for _, w_ in inputs]}); an overlap tile "
                    "cannot reproduce it")
        return out

    @staticmethod
    def _mark(t: Tensor, rows: np.ndarray) -> Tensor:
        setattr(t, _ATTR, np.asarray(rows, bool))
        return t


def global_modules(module: nn.Module) -> List[str]:
    """Submodules that take statistics over the whole image (a tile cannot
    reproduce them), by name."""
    from ..nn.norm import InstanceNorm2D

    return [f"{name} ({type(m).__name__})"
            for name, m in module.named_modules()
            if isinstance(m, InstanceNorm2D)]


def row_halo(fn: Callable[[Tensor], Tensor], probe: Tensor
             ) -> Tuple[int, int]:
    """(top, bottom): how many rows of ``fn(probe)`` at each edge depend on
    rows past that edge.  ``fn`` runs once, under the row tracker."""
    x = probe.clone()
    setattr(x, _ATTR, np.zeros(x.shape[2], bool))
    with torch.no_grad(), _RowTracker():
        y = fn(x)
    wrong = _tracked(y)
    if wrong is None:
        raise SpatialSplitError("the transform's output lost its rows")
    if wrong.all():
        raise SpatialSplitError("the probe is too short for the transform's "
                                "receptive field")
    ok = np.flatnonzero(~wrong)
    if np.any(wrong[ok[0]:ok[-1] + 1]):
        raise SpatialSplitError("rows inside the probe depend on its edges")
    return int(ok[0]), int(len(wrong) - 1 - ok[-1])


def grid_margin(module: nn.Module, fn: Callable[[Tensor], Tensor],
                in_rows: int, out_rows: int, channels: int,
                width: int) -> int:
    """The overlap margin, in grid rows, of ``fn`` (which runs ``module``),
    a transform of ``in_rows`` input rows to ``out_rows`` output rows per
    grid row.  Raises ``SpatialSplitError`` for a transform with a global
    operation (named) or one the row tracker cannot follow."""
    named = global_modules(module)
    if named:
        raise SpatialSplitError(
            "a spatial split cannot reproduce statistics over the whole "
            "image: " + ", ".join(named))
    grid = 32
    while True:
        probe = torch.zeros(1, channels, grid * in_rows, width)
        try:
            top, bottom = row_halo(fn, probe)
        except SpatialSplitError as e:
            if "too short" not in str(e) or grid >= 1024:
                raise
            grid *= 4
            continue
        return math.ceil(max(top, bottom) / out_rows)


# ---------------- the tiles ----------------------------------------------------

def tile_plan(grid_rows: int, n: int, margin: int
              ) -> Optional[List[Tuple[int, int, int, int]]]:
    """Per device: (tile's first grid row, its end, own rows' first, own
    rows' end), in grid rows; None when ``grid_rows`` does not divide by
    ``n`` (the image then runs whole on the first device)."""
    if grid_rows % n:
        return None
    k = grid_rows // n
    return [(max(0, i * k - margin), min(grid_rows, (i + 1) * k + margin),
             i * k, (i + 1) * k) for i in range(n)]


def split_rows(x: Tensor, plan, in_rows: int) -> List[Tensor]:
    """The input tiles of ``plan`` (NCHW, rows of ``in_rows`` per grid
    row), each contiguous (the kernels take contiguous inputs)."""
    return [x[:, :, t0 * in_rows:t1 * in_rows].contiguous()
            for t0, t1, _, _ in plan]


def join_rows(outs: Sequence[Tensor], plan, out_rows: int,
              device: torch.device) -> Tensor:
    """Each tile's own rows, cropped and joined in order on ``device``."""
    parts = [y[:, :, (g0 - t0) * out_rows:(g1 - t0) * out_rows].to(device)
             for y, (t0, _, g0, g1) in zip(outs, plan)]
    return torch.cat(parts, dim=2)


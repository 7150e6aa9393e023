"""One image's height split over a mesh (counterpart of
``crdr_tpu/parallel/spatial.py``).

JAX shards the height of an NHWC image over a mesh and lets XLA insert
each convolution's halo exchange, and a collective for each statistic
over the whole image.  Eager PyTorch has no partitioner, so the port uses
overlap tiles: each device takes its block of rows plus a margin on each
side that holds the whole receptive field of its edge rows, runs the
transform on that tile, and keeps its own rows.  Past an image border the
tile ends where the image does, so its padding is the whole image's.  The
result equals the unsplit transform's exactly up to the order of sums (on
the CPU the bytes are equal; on the card cuDNN may pick other algorithms
for other shapes).

A global operation cuts each tile's pipeline: ``InstanceNorm2D`` (HiFiC
with ``channel_norm: False``) takes its mean and variance over the whole
image, through ``image_moments``.  Inside a split call the tiles share one
``TileExchange``: at each such norm every tile posts the partial moments
of its own rows (count, sum and the sum of squares around its own mean,
in float64), waits at a barrier until every tile has posted, combines the
partials in tile order (never in order of arrival: the stream must not
depend on which replica got there first) and normalizes with the global
moments, cast to the dtype ``torch.mean`` / ``torch.var`` would return.
Outside a split the norm computes what it always did; inside a tile
without an exchange it raises, it never normalizes with local moments.
``InstanceNorm2D`` is the one global module the exchange knows.  Its
moments are the whole image's up to the order of their sums (an ulp
from ``torch.mean`` / ``torch.var``), so through a few norms the split's
latent is a few ulps from the whole's, and a symbol whose ``y - mean``
lies that close to a rounding boundary can come out apart, on the CPU
too (JAX's collective sums in its own order as well).

The margin is computed from the transform, not written down: ``row_halo``
runs it once on a small probe on the CPU under a ``TorchFunctionMode``
that follows, for every tensor, which of its rows depend on rows past the
probe's top and bottom edges, from each operation's own geometry: the
kernel size, stride, padding and dilation of a convolution, the same of a
transposed convolution, reflect / zero padding (HiFiC's 7x7 stem),
pixel-shuffle and nearest up-sampling; the operations known to be
row-local (``_ROW_LOCAL``: elementwise, dtype casts, reductions and joins
that keep the height) carry the rows of their inputs.  A known global
module's moments count as constants there (they carry no rows), and the
tracker records which rows of its input depend on the edges: the margin
must hold them too, so that each tile's own rows are exact where the
moments are taken.  Any other operation that mixes the whole height (a
mean over it taken directly) raises ``SpatialSplitError``, as does any
other operation on a tracked tensor that the mode does not know (a
softmax, cumulative sum, flip or roll along the height would shift rows
without changing the shape).

The split is on a grid of rows (the latent rows): a transform maps ``a``
input rows to ``b`` output rows per grid row (the analysis 16 -> 1, the
synthesis 1 -> 16), the tiles start and end on the grid, so a strided
convolution sees its grid in a tile as in the whole image, and a layer of
``r`` rows per grid row finds a tile's own rows at ``(g0 - t0) * r :
(g1 - t0) * r``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch
from torch.overrides import TorchFunctionMode

Tensor = torch.Tensor
_ATTR = "_crdr_wrong_rows"  # a bool array over dim 2 of an NCHW tensor
_local = threading.local()   # .scope: this thread's tracker or tile, if any
# the longest a tile waits for the others: a tile lost without an error
# then breaks the exchange instead of hanging the mesh
_WAIT_S = 600.0


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
    "gdn",  # K3's op (ops/gdn.py): GDN mixes the channels of one pixel
})


class _RowTracker(TorchFunctionMode):
    """Follows the dependence of NCHW rows on the rows past a probe's
    edges (module doc).  ``inputs``: the wrong rows of each global
    module's input, in call order."""

    def __init__(self):
        super().__init__()
        self.inputs: List[np.ndarray] = []
        self._paused = False

    def moments(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """A global module's moments: constants that carry no rows; the
        rows of ``x`` that depend on the edges are recorded."""
        w = _tracked(x)
        if w is not None:
            self.inputs.append(w)
        self._paused = True
        try:
            return _whole_moments(x)
        finally:
            self._paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
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


def _halo(wrong: np.ndarray) -> Tuple[int, int]:
    """(top, bottom): the rows at each edge that depend on the probe's
    edges."""
    if wrong.all():
        raise SpatialSplitError("the probe is too short for the transform's "
                                "receptive field")
    ok = np.flatnonzero(~wrong)
    if np.any(wrong[ok[0]:ok[-1] + 1]):
        raise SpatialSplitError("rows inside the probe depend on its edges")
    return int(ok[0]), int(len(wrong) - 1 - ok[-1])


def _trace(fn: Callable[[Tensor], Tensor], probe: Tensor
           ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """``fn(probe)`` once under the row tracker: the wrong rows of its
    output and of each global module's input."""
    x = probe.clone()
    setattr(x, _ATTR, np.zeros(x.shape[2], bool))
    tracker = _RowTracker()
    with torch.no_grad(), _scope(tracker), tracker:
        y = fn(x)
    wrong = _tracked(y)
    if wrong is None:
        raise SpatialSplitError("the transform's output lost its rows")
    return wrong, tracker.inputs


def row_halo(fn: Callable[[Tensor], Tensor], probe: Tensor
             ) -> Tuple[int, int]:
    """(top, bottom): how many rows of ``fn(probe)`` at each edge depend on
    rows past that edge.  ``fn`` runs once, under the row tracker."""
    return _halo(_trace(fn, probe)[0])


def grid_margin(fn: Callable[[Tensor], Tensor], in_rows: int,
                out_rows: int, channels: int, width: int
                ) -> Tuple[int, int]:
    """(the overlap margin in grid rows, the global operations a call) of
    ``fn``, a transform of ``in_rows`` input rows to ``out_rows`` output
    rows per grid row.  The margin holds the output's halo and the halo of
    each global module's input (module doc).  Raises ``SpatialSplitError``
    for a transform the row tracker cannot follow."""
    grid = 32
    while True:
        probe = torch.zeros(1, channels, grid * in_rows, width)
        try:
            out, inputs = _trace(fn, probe)
            need = [_halo(out) + (out_rows,)]
            for w in inputs:
                r, rem = divmod(len(w), grid)
                if rem or not r:
                    raise SpatialSplitError(
                        f"a global operation on {len(w)} rows, not a whole "
                        f"number of rows per grid row of {grid}")
                need.append(_halo(w) + (r,))
        except SpatialSplitError as e:
            if "too short" not in str(e) or grid >= 1024:
                raise
            grid *= 4
            continue
        return (max(math.ceil(max(top, bottom) / r)
                    for top, bottom, r in need), len(inputs))


# ---------------- the moments of a global operation ---------------------------

@contextlib.contextmanager
def _scope(scope):
    saved = getattr(_local, "scope", None)
    _local.scope = scope
    try:
        yield scope
    finally:
        _local.scope = saved


def _whole_moments(x: Tensor) -> Tuple[Tensor, Tensor]:
    return (torch.mean(x, dim=(2, 3), keepdim=True),
            torch.var(x, dim=(2, 3), keepdim=True, correction=0))


def image_moments(x: Tensor) -> Tuple[Tensor, Tensor]:
    """The mean and biased variance of NCHW ``x`` over its rows and columns
    (keepdim), for a global module (``InstanceNorm2D``): ``torch.mean`` /
    ``torch.var`` of ``x``; inside a split call's tile the image's, through
    its exchange (a tile without one raises); under the row tracker,
    constants (module doc)."""
    scope = getattr(_local, "scope", None)
    if scope is None:
        return _whole_moments(x)
    return scope.moments(x)


def _partial_moments(x: Tensor) -> Tuple[int, Tensor, Tensor]:
    """(count, sum, sum of squares around their mean) of NCHW ``x`` per
    (image, channel) over its rows and columns, in float64."""
    n = x.shape[2] * x.shape[3]
    xd = x.double()
    total = xd.sum(dim=(2, 3))
    m2 = torch.square(xd - (total / n)[..., None, None]).sum(dim=(2, 3))
    return n, total, m2


def _combine_moments(parts: Sequence[Tuple[int, Tensor, Tensor]]
                    ) -> Tuple[Tensor, Tensor]:
    """The mean and biased variance, float64, of the data whose
    ``_partial_moments`` are ``parts``, summed in their order."""
    n = sum(c for c, _, _ in parts)
    total = parts[0][1]
    for _, s, _ in parts[1:]:
        total = total + s
    mean = total / n
    m2 = None
    for c, s, q in parts:
        term = q + c * torch.square(s / c - mean)
        m2 = term if m2 is None else m2 + term
    return mean, m2 / n


class TileExchange:
    """The moments of one split call's global operations, shared by its
    tiles (module doc).  One slot a tile, a barrier of ``len(plan)``
    parties, and two sets of slots used in turn: a tile posts round k + 2
    only after every tile has passed the barrier of round k + 1, so after
    each has read round k.  ``release``: the context a tile waits in (the
    codec's host section, which lets go of its precision lock).  ``rounds``
    counts the exchanges."""

    def __init__(self, plan, release=contextlib.nullcontext):
        self.plan = list(plan)
        n = len(self.plan)
        self._slots = [[None] * n, [None] * n]
        self._next = [0] * n  # each tile's next round
        self._barrier = threading.Barrier(n, action=self._count,
                                          timeout=_WAIT_S)
        self._release = release
        self.rounds = 0
        self.failure: Optional[BaseException] = None

    def _count(self) -> None:
        self.rounds += 1

    def abort(self, failure: BaseException) -> None:
        """A tile failed: the others stop waiting and raise."""
        if self.failure is None:
            self.failure = failure
        self._barrier.abort()

    def own_rows(self, i: int, x: Tensor) -> Tensor:
        """Tile ``i``'s own rows of the layer ``x`` (NCHW, the whole tile's
        height)."""
        t0, t1, g0, g1 = self.plan[i]
        r, rem = divmod(x.shape[2], t1 - t0)
        if rem:
            raise SpatialSplitError(
                f"a global operation on {x.shape[2]} rows of a tile of "
                f"{t1 - t0} grid rows")
        return x[:, :, (g0 - t0) * r:(g1 - t0) * r]

    def moments(self, i: int, x: Tensor) -> Tuple[Tensor, Tensor]:
        """Tile ``i``'s post for the layer ``x``, then the image's moments,
        combined in tile order on ``x``'s device, in ``x``'s dtype."""
        k = self._next[i]
        self._next[i] += 1
        slots = self._slots[k % 2]
        slots[i] = _partial_moments(self.own_rows(i, x))
        try:
            with self._release():
                self._barrier.wait()
        except threading.BrokenBarrierError:
            raise SpatialSplitError(
                "the tile exchange broke: another tile failed or the wait "
                "timed out") from self.failure
        mean, var = _combine_moments([(c, s.to(x.device), q.to(x.device))
                                     for c, s, q in slots])
        return (mean.to(x.dtype)[..., None, None],
                var.to(x.dtype)[..., None, None])


class _Tile:
    def __init__(self, exchange: Optional[TileExchange], i: int):
        self.exchange, self.i = exchange, i

    def moments(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        if self.exchange is None:
            raise SpatialSplitError(
                "a statistic over the whole image inside a spatial tile "
                "with no exchange: the tile's own rows are not the image")
        return self.exchange.moments(self.i, x)


@contextlib.contextmanager
def tile(exchange: Optional[TileExchange], i: int):
    """Inside the block this thread runs tile ``i`` of a split call: a
    global module takes its moments through ``exchange`` (None: it
    raises).  A failure in the block breaks the exchange, so the other
    tiles do not wait for this one."""
    with _scope(_Tile(exchange, i)):
        try:
            yield
        except BaseException as e:
            if exchange is not None:
                exchange.abort(e)
            raise


def tile_exchange() -> Optional[TileExchange]:
    """The exchange of the tile this thread runs, if any."""
    scope = getattr(_local, "scope", None)
    return scope.exchange if isinstance(scope, _Tile) else None


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


"""Bjontegaard-delta (BD) metrics between two rate-distortion curves
(the port's own copy of ``crdr_tpu/metrics/bd.py``; numpy and scipy only).

The reference repo publishes its headline results as RD curves (its
``rd_results/{kodak,CLIC,DIV2K}.csv``: bpp / PSNR / FID / LPIPS / DISTS
over the 17-point quality sweep) and the paper compares codecs by
BD-rate.  This module provides that comparison for the sweeps of
``crdr_tpu_torch/cli/rd_sweep.py`` against any anchor curve, reference
CSVs included.

Two interpolation backends:

- ``method="akima"`` (default): piecewise-cubic interpolation of
  metric-vs-log(rate) via scipy's Akima spline — the interpolator
  recommended by the modern BD literature (avoids the overshoot artifacts
  of a single global cubic on non-convex curves; see e.g. the VTM common
  test conditions' switch away from poly3).
- ``method="poly3"``: the classic Bjontegaard 2001 global cubic fit, kept
  for cross-checking against legacy numbers.

Both integrate the gap between the curves over the overlapping range.
BD-rate is the average rate difference in percent at equal quality
(negative = the test codec spends fewer bits); BD-quality is the average
metric difference at equal rate (positive = better, for either metric
orientation).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["bd_rate", "bd_quality"]


def _axis_sort(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by x and drop near-duplicate x values (real sweeps can emit
    repeated operating points); interpolators need strictly increasing x."""
    order = np.argsort(x)
    x, y = x[order], y[order]
    keep = np.concatenate([[True], np.diff(x) > 1e-12])
    return x[keep], y[keep]


def _validate(rate: Sequence[float], metric: Sequence[float],
              higher_better: bool) -> Tuple[np.ndarray, np.ndarray]:
    r = np.asarray(rate, np.float64)
    m = np.asarray(metric, np.float64)
    if r.ndim != 1 or r.shape != m.shape or r.size < 4:
        raise ValueError(f"need >=4 aligned (rate, metric) points, got "
                         f"{r.shape} / {m.shape}")
    if np.any(r <= 0):
        raise ValueError("rates must be positive (bpp)")
    if not higher_better:
        m = -m  # uniform higher-is-better metric axis
    return r, m


def _interp(x: np.ndarray, y: np.ndarray, method: str):
    if method == "akima":
        from scipy.interpolate import Akima1DInterpolator

        f = Akima1DInterpolator(x, y)
        return lambda grid: f(grid)
    if method == "poly3":
        coef = np.polyfit(x, y, 3)
        return lambda grid: np.polyval(coef, grid)
    raise ValueError(f"unknown method {method!r} (akima|poly3)")


def _bd_gap(x1, y1, x2, y2, method: str) -> float:
    """Average (y2 - y1) over the overlapping x range, numerically
    integrated on a dense grid (robust for both backends; the classic
    closed-form poly3 integral matches to ~1e-10 on smooth curves).
    Inputs are sorted/deduped on their x axes here."""
    x1, y1 = _axis_sort(np.asarray(x1), np.asarray(y1))
    x2, y2 = _axis_sort(np.asarray(x2), np.asarray(y2))
    lo = max(x1.min(), x2.min())
    hi = min(x1.max(), x2.max())
    if hi <= lo:
        raise ValueError("curves do not overlap on the integration axis")
    grid = np.linspace(lo, hi, 1024)
    g1 = _interp(x1, y1, method)(grid)
    g2 = _interp(x2, y2, method)(grid)
    return float(np.trapezoid(g2 - g1, grid) / (hi - lo))


def bd_rate(anchor_rate: Sequence[float], anchor_metric: Sequence[float],
            test_rate: Sequence[float], test_metric: Sequence[float],
            higher_better: bool = True, method: str = "akima") -> float:
    """BD-rate of the test curve vs the anchor, in percent.

    Negative means the test codec needs fewer bits for the same quality.
    ``higher_better=False`` for loss-like metrics (LPIPS, DISTS, FID).
    """
    ar, am = _validate(anchor_rate, anchor_metric, higher_better)
    tr, tm = _validate(test_rate, test_metric, higher_better)
    # integrate log-rate over the metric axis
    gap = _bd_gap(am, np.log(ar), tm, np.log(tr), method)
    return float((np.exp(gap) - 1.0) * 100.0)


def bd_quality(anchor_rate: Sequence[float], anchor_metric: Sequence[float],
               test_rate: Sequence[float], test_metric: Sequence[float],
               higher_better: bool = True, method: str = "akima") -> float:
    """BD-quality (e.g. BD-PSNR in dB): average metric gain of the test
    curve over the anchor at equal rate.  Positive = test is better, for
    both metric orientations (loss-like metrics are sign-flipped
    internally, so e.g. BD-LPIPS > 0 still reads "test wins")."""
    ar, am = _validate(anchor_rate, anchor_metric, higher_better)
    tr, tm = _validate(test_rate, test_metric, higher_better)
    return _bd_gap(np.log(ar), am, np.log(tr), tm, method)

"""The checkerboard's compressai-wire symbol order (host numpy).

Counterpart of the checkerboard helpers of
``crdr_tpu/models/codec_common.py`` (``_checkerboard_serialize``,
``_merge_np``): per slice, the anchor subgrids A1 = [0::2, 0::2] and
A2 = [1::2, 1::2], then the non-anchor subgrids NA1 = [0::2, 1::2] and
NA2 = [1::2, 0::2], each channel-major.
"""

from __future__ import annotations

import numpy as np


def _checkerboard_serialize(arr: np.ndarray, num_slices: int) -> np.ndarray:
    """NHWC -> the 1-D stream order (see the module doc)."""
    parts = []
    for s in np.split(arr, num_slices, axis=-1):
        for g in (s[:, 0::2, 0::2], s[:, 1::2, 1::2], s[:, 0::2, 1::2],
                  s[:, 1::2, 0::2]):
            parts.append(g.transpose(0, 3, 1, 2).reshape(-1))
    return np.concatenate(parts)


def _merge_np(a1, a2, na1, na2) -> np.ndarray:
    """The four NHWC subgrids back onto one grid."""
    n, h2, w2, c = a1.shape
    out = np.zeros((n, h2 * 2, w2 * 2, c), a1.dtype)
    out[:, 0::2, 0::2] = a1
    out[:, 1::2, 1::2] = a2
    out[:, 0::2, 1::2] = na1
    out[:, 1::2, 0::2] = na2
    return out

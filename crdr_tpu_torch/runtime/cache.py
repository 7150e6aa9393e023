"""Warm the build cache before serving.

Counterpart of ``crdr_tpu/runtime/cache.py``.  JAX warms a persistent
compilation cache so that no request pays a compile.  The port compiles no
program per shape; what a cold process builds is its native libraries
(``utils/device.py::build_library``, into ``build/crdr_tpu_torch/``): the
host rANS coder with g++ and, on a GPU, each CUDA kernel the model's codec
path launches with nvcc.  ``warm_kernel_cache`` builds them all at once (or
finds them up to date), so the first request builds nothing.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from .. import runtime
from ..nn import GDN
from ..ops import gdn, lane_decode, lane_encode, slice_transform


def warm_kernel_cache(model) -> Dict[str, str]:
    """Build what the model's codec path runs (call after ``codec_setup``):
    the host rANS coder always; on a GPU K1 (the fused SliceTransform, when
    ``fused_slice_kernel`` is on), K2 and E1 (the device wire's decode and,
    with ``device_wire_encoder: device``, its encode) and K3 (a model with
    GDN layers).  Each library builds in its own thread (one compiler a
    source, all started together); returns {library: path}.  A failed
    build raises."""
    builds = {"host rANS": runtime.build}
    if model.device.type == "cuda":
        if model.use_charm and model.fused_slice_kernel:
            builds["slice_transform"] = slice_transform.build
        if model.wire_format == "device":
            builds["lane_decode"] = lane_decode.build
            if model.device_wire_encoder == "device":
                builds["lane_encode"] = lane_encode.build
        if any(isinstance(m, GDN) for m in model.net.modules()):
            builds["gdn"] = gdn.build
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {name: ex.submit(fn) for name, fn in builds.items()}
        return {name: fut.result() for name, fut in futs.items()}

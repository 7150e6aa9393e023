"""Weight files that are pickles of numpy arrays (the LPIPS, Inception and
DISTS converters' format): read with an unpickler that admits the classes
a dict of numpy arrays needs and no other."""

from __future__ import annotations

import pickle
from typing import Any


class _NumpyUnpickler(pickle.Unpickler):
    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"weight files may hold numpy arrays only, not "
                f"{module}.{name}")
        return super().find_class(module, name)


def load_numpy_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()

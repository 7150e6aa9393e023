"""Wall-clock iteration-rate / ETA stats (counterpart of
``crdr_tpu/utils/timer.py``; reference src/utils/timer.py)."""

from __future__ import annotations

import time
from typing import Dict


class Timer:
    def __init__(self, start_iter: int = 0, end_iter: int = 0):
        self.start_iter = start_iter
        self.end_iter = end_iter
        self.start_time = None
        self.last_time = None
        self.last_iter = start_iter

    def start(self) -> None:
        self.start_time = time.time()
        self.last_time = self.start_time
        self.last_iter = self.start_iter

    def get_time_stat(self, current_iter: int) -> Dict[str, float]:
        now = time.time()
        interval = now - self.last_time
        interval_iters = max(current_iter - self.last_iter, 1)
        sec_per_iter = interval / interval_iters
        remaining = (self.end_iter - current_iter) * sec_per_iter
        stat = {
            "sec_per_iter": sec_per_iter,
            "iter_per_sec": 1.0 / sec_per_iter if sec_per_iter > 0 else 0.0,
            "elapsed_hours": (now - self.start_time) / 3600.0,
            "eta_hours": remaining / 3600.0,
        }
        self.last_time = now
        self.last_iter = current_iter
        return stat

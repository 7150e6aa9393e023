"""Logging utilities: the package logger, AvgMeter, CSVLogger (counterpart
of ``crdr_tpu/utils/logger.py``; reference src/utils/logger.py).

``get_root_logger`` configures the ``crdr_tpu_torch`` logger, the parent of
every module logger of the port (``logging.getLogger(__name__)``): a
console handler once, and a file handler when a log file is given.
"""

from __future__ import annotations

import csv
import logging
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional

_NAME = "crdr_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)s: %(message)s"


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_NAME)
    if not any(getattr(h, "_crdr_console", False) for h in logger.handlers):
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(log_level)
        sh.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        sh._crdr_console = True
        logger.addHandler(sh)
    if log_file is not None and not any(
            isinstance(h, logging.FileHandler)
            and h.baseFilename == os.path.abspath(log_file)
            for h in logger.handlers):
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


def bolded_log(msg: str, level: str = "INFO", new_line: bool = False,
               prefix: str = "===== ", suffix: str = " =====") -> None:
    text = f"{prefix}{msg}{suffix}"
    getattr(get_root_logger(), level.lower())("\n" + text if new_line
                                              else text)


def log_dict_items(d: Dict, level: str = "INFO", indent: bool = False) -> None:
    logger = get_root_logger()
    pad = "    " if indent else ""
    for k, v in d.items():
        getattr(logger, level.lower())(f"{pad}{k}: {v}")


class AvgMeter:
    """Windowed mean of scalar loss values keyed by name."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def update(self, values: Dict[str, float]) -> None:
        for k, v in values.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def get_avg_values(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()


class CSVLogger:
    """Append-row CSV logger; rewrites the header when new keys appear."""

    def __init__(self, log_path: str, resume: bool = False):
        self.log_path = log_path
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        self._fieldnames: List[str] = []
        self._rows: List[Dict] = []
        if resume and os.path.exists(log_path):
            with open(log_path, newline="") as f:
                reader = csv.DictReader(f)
                self._fieldnames = list(reader.fieldnames or [])
                self._rows = [dict(r) for r in reader]

    def update(self, row: Dict) -> None:
        row = {k: (f"{v:.6g}" if isinstance(v, float) else v)
               for k, v in row.items()}
        for k in row:
            if k not in self._fieldnames:
                self._fieldnames.append(k)
        self._rows.append(row)
        with open(self.log_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            for r in self._rows:
                writer.writerow(r)

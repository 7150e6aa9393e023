"""Experiment directory / checkpoint path layout (counterpart of
``crdr_tpu/utils/path.py``; reference src/utils/path.py)."""

from __future__ import annotations

import os
import os.path as osp


def iter2str(itr: int) -> str:
    """1000 -> '1K', 999 -> '999' (reference path.py:43)."""
    if itr % 1000 == 0 and itr > 0:
        return f"{itr // 1000}K"
    return str(itr)


class PathHandler:
    def __init__(self, ckpt_root: str, exp: str):
        self.ckpt_root = ckpt_root
        self.exp = exp
        self.job_dir = osp.join(ckpt_root, exp)
        self.model_dir = osp.join(self.job_dir, "model")
        self.sample_dir = osp.join(self.job_dir, "sample")

    def make_job_dir(self) -> None:
        os.makedirs(self.model_dir, exist_ok=True)
        os.makedirs(self.sample_dir, exist_ok=True)

    def get_ckpt_path(self, label: str, itr: int) -> str:
        return osp.join(self.model_dir, f"{label}_iter{iter2str(itr)}.ckpt")

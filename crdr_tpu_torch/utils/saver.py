"""Checkpoint saver with rolling deletion (counterpart of
``crdr_tpu/utils/saver.py``; reference src/utils/model_saver.py).

Checkpoints are ``torch.save`` files, one per label:
``{label}_iter{N|NK}.ckpt``, holding ``{"iter": N, **state}``; tensors are
saved from the CPU.  They are read back with ``weights_only=True`` (tensors
and plain containers, no code runs).  On saving iter N, the checkpoint of
``N - save_step`` is removed unless ``keep`` is set and it is in
``keep_step`` (a list, or an int period).  The JAX package's checkpoints
(msgpack pytrees) are another format, which the port does not read.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Any, Dict, List, Union

import torch

from .path import PathHandler

logger = logging.getLogger(__name__)


def save_checkpoint(obj: Any, path: str) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


class Saver:
    def __init__(self, ckpt_root: str, exp: str, save_step: int,
                 keep_step: Union[List[int], int, None] = None):
        self.path_handler = PathHandler(ckpt_root, exp)
        self.path_handler.make_job_dir()
        self.save_step = save_step
        self.keep_step = [] if keep_step is None else keep_step

    def _should_keep(self, itr: int) -> bool:
        if isinstance(self.keep_step, int):
            return self.keep_step > 0 and itr % self.keep_step == 0
        return itr in self.keep_step

    def save(self, state_dict: Dict[str, Any], label: str, current_iter: int,
             keep: bool = True) -> str:
        path = self.path_handler.get_ckpt_path(label, current_iter)
        save_checkpoint({"iter": current_iter, **state_dict}, path)
        prev = current_iter - self.save_step
        if prev > 0 and not (keep and self._should_keep(prev)):
            prev_path = self.path_handler.get_ckpt_path(label, prev)
            if osp.exists(prev_path):
                try:
                    os.remove(prev_path)
                except OSError:
                    logger.warning(f"failed to remove {prev_path}")
        return path

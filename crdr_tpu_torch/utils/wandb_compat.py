"""Optional wandb logging (counterpart of ``crdr_tpu/utils/wandb_compat.py``):
the real ``wandb`` when it is installed, else a JSONL stream, so that
``use_wandb: True`` (``train -wb``) runs where ``wandb`` is not installed.

``init`` takes the reference's arguments (project / name / id / resume);
``log`` appends one line ``{"_ts": <time>, **data}`` to
``{log_dir}/wandb_{name}.jsonl`` on the JSONL backend.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from .logger import get_root_logger

_backend = None


class _JsonlRun:
    def __init__(self, log_path: str):
        self.log_path = log_path
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)

    def log(self, data: Dict) -> None:
        with open(self.log_path, "a") as f:
            f.write(json.dumps({"_ts": time.time(), **data}) + "\n")

    def finish(self) -> None:
        pass


def init(project: str, name: str, run_id: Optional[str] = None,
         config: Optional[Dict] = None, resume: bool = False,
         wandb_dir: str = "./", log_dir: Optional[str] = None):
    """Returns an object with ``.log(dict)`` / ``.finish()``."""
    global _backend
    try:
        import wandb

        _backend = wandb.init(dir=wandb_dir, project=project, name=name,
                              id=run_id or name, config=config,
                              resume=resume)
    except ImportError:
        path = os.path.join(log_dir or ".", f"wandb_{name}.jsonl")
        get_root_logger().warning(
            f"wandb not installed; metrics stream to {path}")
        _backend = _JsonlRun(path)
    return _backend


def log(data: Dict) -> None:
    if _backend is not None:
        _backend.log(data)

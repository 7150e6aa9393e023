"""Training CLI of the port (counterpart of ``scripts/train.py``; reference
scripts/train.py:16-27): the config with its command-line overrides, the
experiment directory, ``--auto_resume`` from the newest checkpoint there,
then ``build_trainer(opt).train_loop()``.

Usage, from the root of a checkout (on the GPU unless ``-d cpu``):
    python -m crdr_tpu_torch.cli.train config/endurance_stage1.yaml \\
        [--total_iter N --save_step N ...]

Several devices: ``--n_devices N`` (or the config's ``n_devices``) starts N
ranks on this machine, one a GPU (``cuda:0 .. N-1``; fewer cards raise),
or N CPU processes over gloo with ``-d cpu``, and trains data-parallel
(``trainer/base_trainer.py``); ``--distributed`` first joins the process
group that ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
configure (one process a host, each on its first card), as
``scripts/train.py`` calls ``init_distributed``.

Checkpoints and logs go to ``{ckpt_root}/{exp}/`` (``./checkpoint`` by
default; ``exp`` is the config's file name), from rank 0.  A recipe with
LPIPS needs the weights (``weights_path`` / ``CRDR_LPIPS_WEIGHTS``) or
``allow_random``.
"""

from __future__ import annotations

import os
import re
from glob import glob

import torch

from ..parallel import distributed as dist
from ..parallel.mesh import make_mesh
from ..trainer import build_trainer
from ..utils.config import get_train_config
from ..utils.logger import get_root_logger
from ..utils.path import PathHandler


def main(argv=None) -> None:
    opt = get_train_config(argv)
    device = opt.get("device")
    if opt.get("distributed"):
        dist.init_distributed(backend=dist.default_backend(device or "cuda"))
    PathHandler(opt.ckpt_root, opt.exp).make_job_dir()
    logger = get_root_logger(
        log_file=opt.path.log_file_path if dist.rank() == 0 else None)
    logger.info(f"experiment: {opt.exp} (host {opt.host})")
    if opt.get("auto_resume") and not opt.start_iter:
        itr = latest_checkpoint_iter(opt)
        if itr:
            opt["start_iter"] = itr
            logger.info(f"auto-resume from iter {itr}")
    if dist.rank() == 0:
        opt.dump(opt.path.config_dump_path)
    n = int(opt.get("n_devices", 0) or 0)
    if n > 1 and not dist.active():
        cpu = device is not None and torch.device(device).type == "cpu"
        dist.spawn(train_rank, n, devices=make_mesh(
            n, [torch.device("cpu")] * n if cpu else None), args=(opt,))
        return
    build_trainer(opt, device).train_loop()


def train_rank(rank: int, world: int, device: torch.device, opt) -> None:
    """One rank of ``--n_devices``: its trainer on its device (rank 0 keeps
    the log file)."""
    get_root_logger(log_file=opt.path.log_file_path if rank == 0 else None)
    build_trainer(opt, device).train_loop()


def latest_checkpoint_iter(opt) -> int:
    """The newest comp_model checkpoint's iteration in the experiment dir
    (0 if none); file names use ``iter2str`` (e.g. iter15K)."""
    iters = []
    for p in glob(os.path.join(opt.ckpt_root, opt.exp, "model",
                               "comp_model_iter*.ckpt")):
        m = re.search(r"iter(\d+)([KM]?)\.ckpt$", os.path.basename(p))
        if m:
            mult = {"": 1, "K": 1000, "M": 1000000}[m.group(2)]
            iters.append(int(m.group(1)) * mult)
    return max(iters) if iters else 0


if __name__ == "__main__":
    main()

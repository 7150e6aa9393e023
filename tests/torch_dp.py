"""Rank functions of the port's data-parallel and serving-mesh tests
(``tests/test_torch_parallel*.py``).  ``crdr_tpu_torch.parallel.spawn``
starts each rank in a fresh process that imports this module by name, so
it imports no JAX: the configs are built in the test process and passed
in as plain dicts."""

from __future__ import annotations

import numpy as np

import torch

from crdr_tpu_torch.data import cycle
from crdr_tpu_torch.trainer import build_trainer
from crdr_tpu_torch.utils.config import Config, fill_paths


def trainer_of(opt_dict, device, **over):
    cfg = Config(dict(opt_dict, **over))
    fill_paths(cfg)
    return build_trainer(cfg, device)


def build_rank(rank: int, world: int, device, opt_dict: dict) -> None:
    """Only build the trainer (its refusals)."""
    trainer_of(opt_dict, device)


def params_of(tr) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in tr.comp_model.net.named_parameters()}


def run_steps(rank: int, world: int, device, opt_dict: dict, steps: int,
              save_at: int = 0, threads: int = 1) -> dict:
    """``steps`` steps of the trainer of ``opt_dict`` on its own loader
    (with ``save_at``, a checkpoint after that step): each step's log, the
    main optimizer's averaged gradient after step 1, the parameters after
    the last step, and this rank's rows of each batch."""
    torch.set_num_threads(threads)
    tr = trainer_of(opt_dict, device)
    out = {"logs": [], "rows": [], "rank": tr.rank, "world": tr.world}
    for itr, data in cycle(tr.train_loader, 0, steps):
        out["rows"].append(np.asarray(data["real_images"]).copy())
        out["logs"].append(tr.optimize_parameters(itr, data))
        if itr == 1:
            out["grad1"] = tr.g_opt.flat_grad.cpu().numpy().copy()
        if itr == save_at:
            tr.save(itr)
    out["params"] = params_of(tr)
    return out


def rate_loss_rank(rank: int, world: int, device, loss_opt: dict,
                   bpp: np.ndarray, qbpp: np.ndarray, rate_ind: float
                   ) -> dict:
    """The rate loss of this rank's rows of ``bpp`` / ``qbpp`` (the global
    batch's, [B]), with the global switch and with the rank's own."""
    from crdr_tpu_torch.losses import build_loss
    from crdr_tpu_torch.parallel import batch_mean, mean_over_ranks

    k = len(bpp) // world
    rows = slice(rank * k, (rank + 1) * k)
    b, q = (torch.from_numpy(a[rows]) for a in (bpp, qbpp))
    loss = build_loss(loss_opt)
    return {"global": float(mean_over_ranks(loss(b, q, rate_ind=rate_ind,
                                                 batch_mean=batch_mean))),
            "local": float(mean_over_ranks(loss(b, q, rate_ind=rate_ind)))}

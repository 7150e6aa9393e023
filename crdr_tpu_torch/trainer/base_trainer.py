"""Training loop scaffolding (counterpart of
``crdr_tpu/trainer/base_trainer.py``; reference src/trainer/base_trainer.py).

The reference's per-iteration structure is kept: the setup hooks, the loss
/ log / eval / save / time steps, the NaN / Inf / >1e4 skip and the
infinite-cycling loader.  A step runs eagerly on the card and makes no host
sync: the skip is decided on the device (``Optimizer.step(skip)``), and the
loop pulls the steps' logs to the host once per ``log_step`` (JAX's lazy
logging), in one copy.

Numerics: cuDNN runs deterministic algorithms without autotuning (set
process-wide when the trainer is built), so a step after a resume, on the
batch it had before, is bit-equal to the uninterrupted run's (the loader's
order starts again from the seed on a resume, as the JAX package's does); TF32 stays as PyTorch has it.  With
``mixed_precision: True`` the batch goes into the net in bf16 and each conv
casts its weights to its input's dtype, as the JAX package's do: the
analysis and hyper-analysis run in bf16 over f32 weights, and from the
entropy models on, where bf16 meets an f32 tensor, the computation is f32
(the JAX package's promotion rules); the losses are f32.

Several devices: data parallel, one process (rank) a device, joined in a
``torch.distributed`` group (``parallel/distributed.py``; ``python -m
crdr_tpu_torch.cli.train --n_devices N`` starts the ranks, ``--distributed``
joins a configured group).  JAX's step is one SPMD program over the global
batch; here each rank runs the step on its block of rows and the ranks
agree through collectives, so the trajectory is the single process's:

* each rank loads its rows of each global batch in the single-process
  order (``DataLoader(shard=...)``), draws the global batch's noise from
  the shared generator and keeps its rows (``UniformNoise(rank, world)``),
  and samples ``rate_ind`` / ``beta`` from the same host sequence;
* every optimizer's flat gradient buffer is averaged over the ranks, one
  all-reduce a step, before the clip and the update; the parameters start
  from rank 0's (a broadcast);
* the statistics JAX takes over the global batch are global: the rate
  loss's switch, the anomaly skip (every rank skips together), the logs;
* rank 0 alone writes the checkpoints (the single-process format: a
  checkpoint of N ranks resumes in one process and the reverse), the CSV
  logs and the validation.

``batch_size`` must divide by the ranks.

``use_wandb`` (``train -wb``) logs where the JAX package's trainer does,
through ``utils/wandb_compat.py`` (rank 0 alone): ``eval_*`` after each
validation, the training loss every ``wandb_loss_step`` iterations (10000
by default) at a log step, and the time stats at each time step.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..data import DataLoader, build_dataset, cycle
from ..entropy import UniformNoise
from ..models import build_comp_model
from ..models.codec import device_uint8_to_tensor
from ..parallel import distributed as dist
from ..utils.device import resolve_device
from ..utils.logger import (AvgMeter, CSVLogger, bolded_log, get_root_logger,
                            log_dict_items)
from ..utils.path import PathHandler
from ..utils.saver import Saver
from ..utils.timer import Timer

Tensor = torch.Tensor


class BaseTrainer:
    micro_batches = 1  # the RD trainer's blocks a step (rd_trainer.py)

    def __init__(self, opt, device=None):
        self.opt = opt
        self.rank, self.world = self.data_parallel(opt)
        # collectives whenever this process is a rank of a group, even of
        # one (a group over NCCL at world size 1 runs them too)
        self.dp = dist.active()
        # the step's collectives: the optimizers' gradient mean, and the
        # mean over the global batch (the rate switch, RaGAN's logits)
        self.grad_mean = dist.all_reduce_mean_ if self.dp else None
        self.batch_mean = dist.batch_mean
        self.device = resolve_device(device if device is not None
                                     else opt.get("device"))
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.logger = get_root_logger(
            log_file=opt.path.log_file_path if opt.get("path") else None)
        self.step = int(opt.start_iter)

        bolded_log("Model", new_line=True)
        self.set_models()
        bolded_log("Optimizers & Schedulers", new_line=True)
        self.set_optimizer_scheduler()
        bolded_log("Loss functions", new_line=True)
        self.set_losses()
        bolded_log("Dataloader", new_line=True)
        self.set_dataloader()
        self.set_csv_loggers()

        self._wandb = None
        if opt.get("use_wandb", False) and self.rank == 0:
            from ..utils import wandb_compat

            self._wandb = wandb_compat
            wandb_compat.init(
                project=opt.get("project_name", "crdr_tpu"), name=opt.exp,
                config=opt.to_dict() if hasattr(opt, "to_dict") else None,
                resume=opt.start_iter > 0,
                wandb_dir=opt.get("wandb_root", "./"),
                log_dir=opt.path.job_dir if opt.get("path") else ".")

        self.loss_recorder = AvgMeter()
        self.time_recorder = Timer(start_iter=opt.start_iter,
                                   end_iter=opt.total_iter)
        self.path_handler = PathHandler(opt.ckpt_root, opt.exp)
        self.model_saver = Saver(opt.ckpt_root, opt.exp, opt.save_step,
                                 opt.get("keep_step", []))
        self._pending_logs: List[Tuple[int, Dict[str, Tensor]]] = []

        if opt.start_iter > 0:
            self.load_checkpoint(opt.exp, opt.start_iter)
        if opt.get("load_checkpoint", None):
            lc = dict(opt.load_checkpoint)
            self.load_checkpoint(lc.pop("exp"), lc.pop("iter"), **lc)
        if self.dp:
            for optim in self.optimizers():
                dist.broadcast_(optim.flat)
        if opt.get("dry_run"):
            self.print_models()
            raise SystemExit(0)

    @staticmethod
    def data_parallel(opt) -> Tuple[int, int]:
        """(rank, world size) of this process in a data-parallel run, (0, 1)
        alone.  ``n_devices`` N > 1 needs a group of N ranks (``cli.train
        --n_devices N`` or ``parallel.spawn`` starts one); ``batch_size``
        must divide by the ranks."""
        n = int(opt.get("n_devices", 0) or 0)
        world = dist.world_size()
        bs = int(opt.dataset.batch_size)
        if bs % max(n, world, 1):
            raise ValueError(f"batch_size {bs} must be divisible by "
                             f"n_devices {max(n, world)}")
        if not dist.active():
            if n > 1:
                raise RuntimeError(
                    f"n_devices: {n} trains one process a device: start it "
                    f"with python -m crdr_tpu_torch.cli.train --n_devices "
                    f"{n}, or build the trainer in each rank of "
                    "crdr_tpu_torch.parallel.spawn")
            return 0, 1
        if n and n != world:
            raise ValueError(f"n_devices {n} in a group of {world} ranks")
        return dist.rank(), world

    def optimizers(self) -> List:
        """The trainer's optimizers (their parameters' flat buffers are what
        the ranks broadcast and average)."""
        raise NotImplementedError

    # ------------------ setup hooks ------------------

    @property
    def noise(self) -> UniformNoise:
        """The training forward's noise source: the model's own, which the
        training state saves and restores."""
        return self.comp_model.noise

    def set_models(self) -> None:
        """The model on the trainer's device, gradients on; with
        ``pretrained_weight_path`` its partial merge's counts (the stage
        handoff) are kept in ``pretrained_counts``."""
        self.comp_model = build_comp_model(self.opt, self.device)
        if self.world > 1:
            self.comp_model.noise = UniformNoise(
                self.comp_model.noise.generator, self.rank, self.world)
        self.pretrained_counts = None
        if self.opt.get("pretrained_weight_path", None):
            self.pretrained_counts = self.comp_model.load_learned_weight(
                self.opt.pretrained_weight_path)
        self.comp_model.net.train().requires_grad_(True)

    def set_optimizer_scheduler(self) -> None:
        raise NotImplementedError

    def set_losses(self) -> None:
        raise NotImplementedError

    def set_dataloader(self) -> None:
        ds_opt = self.opt.dataset
        train_dataset = build_dataset(ds_opt.train_dataset, is_train=True)
        log_dict_items({"batch_size": ds_opt.batch_size,
                        "train_images": len(train_dataset)}, indent=True)
        self.train_loader = DataLoader(
            train_dataset, batch_size=ds_opt.batch_size, shuffle=True,
            drop_last=True, seed=self.opt.get("seed", None),
            num_workers=self.opt.get("num_workers", 8),
            prefetch=self.opt.get("prefetch_batches", 4),
            shard=(self.rank, self.world))
        eval_dataset = build_dataset(ds_opt.eval_dataset, is_train=False)
        self.eval_loader = DataLoader(eval_dataset, batch_size=1)

    def set_csv_loggers(self) -> None:
        """The CSV logs, on rank 0 alone (None elsewhere)."""
        self.train_logger = self.eval_logger = None
        if self.rank == 0:
            resume = self.opt.start_iter > 0
            self.train_logger = CSVLogger(self.opt.path.log_loss_path, resume)
            self.eval_logger = CSVLogger(self.opt.path.log_eval_path, resume)

    def print_models(self) -> None:
        bolded_log("Print Models", level="DEBUG", new_line=True)
        self.logger.info(str(self.comp_model.net))
        n_params = sum(p.numel() for p in self.comp_model.net.parameters())
        self.logger.info(f"total params: {n_params / 1e6:.2f}M")

    # ------------------ main loop ------------------

    def train_loop(self) -> None:
        bolded_log("train_loop start", new_line=True)
        if self.opt.get("path") and self.rank == 0:
            os.makedirs(self.opt.path.job_dir, exist_ok=True)
            self.opt.dump(self.opt.path.config_dump_path)
        self.time_recorder.start()
        for itr, data in cycle(self.train_loader, self.opt.start_iter,
                               self.opt.total_iter):
            self._pending_logs.append(
                (itr, self.optimize_parameters_device(itr, data)))
            if itr % self.opt.log_step == 0:
                self.flush_logs()
                self.log_train_loss(itr)
            if itr % self.opt.eval_step == 0:
                self.flush_logs()
                if self.rank == 0:
                    self.validation(itr)
            if itr % self.opt.save_step == 0:
                self.flush_logs()
                self.save(itr)
            if itr % self.opt.get("time_step", 1000) == 0:
                self.log_time(itr)
        self.flush_logs()

    def flush_logs(self) -> List[Tuple[int, Optional[Dict[str, float]]]]:
        """Pull the pending steps' logs to the host in one copy (averaged
        over the ranks, one all-reduce, in a data-parallel run); a skipped
        step is reported and left out of the averages.  Returns (iter, log
        or None when skipped) per step."""
        pending, self._pending_logs = self._pending_logs, []
        if not pending:
            return []
        keys = [sorted(log) for _, log in pending]
        flat = torch.stack([log[k].to(torch.float32).reshape(())
                            for (_, log), ks in zip(pending, keys)
                            for k in ks])
        if self.dp:
            dist.all_reduce_mean_(flat)
        flat = flat.cpu().tolist()
        out, i = [], 0
        for (itr, _), ks in zip(pending, keys):
            row = dict(zip(ks, flat[i:i + len(ks)]))
            i += len(ks)
            if row.pop("skipped", 0.0) > 0:
                self.logger.warning(f"iter{itr}: skipped (loss anomaly)")
                out.append((itr, None))
                continue
            self.loss_recorder.update(row)
            out.append((itr, row))
        return out

    def optimize_parameters_device(self, itr: int, data: Dict
                                   ) -> Dict[str, Tensor]:
        raise NotImplementedError

    def optimize_parameters(self, itr: int, data: Dict
                            ) -> Optional[Dict[str, float]]:
        """One step, its log pulled to the host at once (a sync); None when
        the step was skipped."""
        self._pending_logs.append(
            (itr, self.optimize_parameters_device(itr, data)))
        return self.flush_logs()[-1][1]

    # ------------------ batches ------------------

    def put_batch(self, batch: np.ndarray) -> Tensor:
        """NHWC numpy (uint8 or float) -> NCHW float32 on the device: uint8
        goes up as uint8 (pinned, asynchronously) and converts there with
        ``uint8_to_tensor``'s exact f32 formula."""
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        if t.dtype == torch.uint8:
            t = device_uint8_to_tensor(t)
        return t.to(torch.float32).permute(0, 3, 1, 2).contiguous()

    def loss_anomaly_flag(self, l_total: Tensor) -> Tensor:
        """NaN / Inf / huge guard, on the device (reference
        base_trainer.py:228-238), on the loss of the global batch (its mean
        over the ranks: every rank skips together)."""
        if self.dp:
            l_total = dist.mean_over_ranks(l_total)
        return torch.isnan(l_total) | torch.isinf(l_total) | (l_total > 1e4)

    # ------------------ logging / eval / save ------------------

    def validation(self, current_iter: int) -> None:
        rows = self.comp_model.validation(self.eval_loader,
                                          max_sample_size=100)
        keys = [k for k in rows[0] if k != "idx"]
        eval_dict = {k: float(np.mean([r[k] for r in rows])) for k in keys}
        self.logger.info(f"validation iter{current_iter}: " + " ".join(
            f"{k}={v:.4f}" for k, v in eval_dict.items()))
        self.eval_logger.update({"iter": current_iter, **eval_dict})
        if self._wandb:
            self._wandb.log({"iter": current_iter,
                             **{f"eval_{k}": v for k, v in eval_dict.items()}})

    def log_train_loss(self, current_iter: int) -> None:
        avg = self.loss_recorder.get_avg_values()
        if self.opt.get("debug"):
            self.logger.info(
                f"loss iter{current_iter}: "
                + " ".join(f"{k}: {v:.3f}" for k, v in avg.items()))
        if self.train_logger is not None:
            self.train_logger.update({"iter": current_iter, **avg})
        if self._wandb and current_iter % self.opt.get("wandb_loss_step",
                                                       10000) == 0:
            self._wandb.log({"iter": current_iter, **avg})
        self.loss_recorder.reset()

    def log_time(self, current_iter: int) -> None:
        stat = self.time_recorder.get_time_stat(current_iter)
        self.logger.info(
            f"iter {current_iter}: {stat['iter_per_sec']:.2f} it/s, "
            f"eta {stat['eta_hours']:.2f}h")
        if self._wandb:
            self._wandb.log({"iter": current_iter, **stat})

    def save(self, current_iter: int) -> None:
        raise NotImplementedError

    def load_checkpoint(self, exp: str, itr: int, **kwargs) -> None:
        raise NotImplementedError


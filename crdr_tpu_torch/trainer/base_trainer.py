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

Left out, as ROADMAP.md says: ``use_wandb``, and several devices
(``n_devices``, ``distributed``).
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
from ..utils.device import resolve_device
from ..utils.logger import (AvgMeter, CSVLogger, bolded_log, get_root_logger,
                            log_dict_items)
from ..utils.path import PathHandler
from ..utils.saver import Saver
from ..utils.timer import Timer

Tensor = torch.Tensor


class BaseTrainer:
    def __init__(self, opt, device=None):
        self.opt = opt
        for key in ("use_wandb", "distributed"):
            if opt.get(key):
                raise NotImplementedError(f"{key} is not ported")
        if int(opt.get("n_devices", 0) or 0) > 1:
            raise NotImplementedError("training on several devices is not "
                                      "ported (ROADMAP.md, Queue 1 item 9)")
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
        if opt.get("dry_run"):
            self.print_models()
            raise SystemExit(0)

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
            prefetch=self.opt.get("prefetch_batches", 4))
        eval_dataset = build_dataset(ds_opt.eval_dataset, is_train=False)
        self.eval_loader = DataLoader(eval_dataset, batch_size=1)

    def set_csv_loggers(self) -> None:
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
        if self.opt.get("path"):
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
                self.validation(itr)
            if itr % self.opt.save_step == 0:
                self.flush_logs()
                self.save(itr)
            if itr % self.opt.get("time_step", 1000) == 0:
                self.log_time(itr)
        self.flush_logs()

    def flush_logs(self) -> List[Tuple[int, Optional[Dict[str, float]]]]:
        """Pull the pending steps' logs to the host in one copy; a skipped
        step is reported and left out of the averages.  Returns (iter, log
        or None when skipped) per step."""
        pending, self._pending_logs = self._pending_logs, []
        if not pending:
            return []
        keys = [sorted(log) for _, log in pending]
        flat = torch.stack([log[k].to(torch.float32).reshape(())
                            for (_, log), ks in zip(pending, keys)
                            for k in ks]).cpu().tolist()
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

    @staticmethod
    def loss_anomaly_flag(l_total: Tensor) -> Tensor:
        """NaN / Inf / huge guard, on the device (reference
        base_trainer.py:228-238)."""
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

    def log_train_loss(self, current_iter: int) -> None:
        avg = self.loss_recorder.get_avg_values()
        if self.opt.get("debug"):
            self.logger.info(
                f"loss iter{current_iter}: "
                + " ".join(f"{k}: {v:.3f}" for k, v in avg.items()))
        self.train_logger.update({"iter": current_iter, **avg})
        self.loss_recorder.reset()

    def log_time(self, current_iter: int) -> None:
        stat = self.time_recorder.get_time_stat(current_iter)
        self.logger.info(
            f"iter {current_iter}: {stat['iter_per_sec']:.2f} it/s, "
            f"eta {stat['eta_hours']:.2f}h")

    def save(self, current_iter: int) -> None:
        raise NotImplementedError

    def load_checkpoint(self, exp: str, itr: int, **kwargs) -> None:
        raise NotImplementedError


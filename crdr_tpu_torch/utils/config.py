"""Config system: YAML with ``_base_`` inheritance, ``_delete_`` overrides and
attribute access, so the port loads the same ``config/*.yaml`` files as the
JAX package (its own copy of ``crdr_tpu/utils/config.py``), and the train
CLI's config (``get_train_config``: the JAX CLI's flags and the experiment
directory layout under ``opt.path``).

A YAML file may list base files in ``_base_``; bases are merged in order, then
the file itself is merged on top.  A dict carrying ``_delete_: True`` replaces
(instead of merges into) the base value.
"""

from __future__ import annotations

import argparse
import copy
import os.path as osp
import socket
import time
from typing import Dict, List, Optional

import yaml

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


class ConfigDict(dict):
    """dict with recursive attribute access (minimal addict clone)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            for k, v in dict(arg).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        out = type(self)()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def to_dict(self) -> Dict:
        def _plain(v):
            if isinstance(v, dict):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [_plain(x) for x in v]
            return v

        return _plain(self)


def merge_dict(a: Dict, b: Dict) -> Dict:
    """Merge dict ``a`` on top of dict ``b`` (a wins), recursively; a dict in
    ``a`` with ``_delete_: True`` replaces ``b``'s value outright."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False):
            if not isinstance(b[k], dict):
                raise TypeError(
                    f"cannot merge dict into non-dict for key '{k}' "
                    f"({type(b[k]).__name__}); add `{DELETE_KEY}: True` to override"
                )
            b[k] = merge_dict(v, b[k])
        else:
            if isinstance(v, dict):
                v.pop(DELETE_KEY, None)
            b[k] = copy.deepcopy(v)
    return b


def load_yaml_with_base(filepath: str) -> Dict:
    """Load a YAML file, recursively resolving its ``_base_`` list."""
    filepath = osp.abspath(osp.expanduser(filepath))
    with open(filepath, "r") as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise TypeError(f"config root must be a mapping: {filepath}")

    base_files = cfg.pop(BASE_KEY, [])
    if isinstance(base_files, str):
        base_files = [base_files]
    merged: Dict = {}
    for base in base_files:
        base_path = base if osp.isabs(base) else osp.join(osp.dirname(filepath), base)
        base_cfg = load_yaml_with_base(base_path)
        # base files must be disjoint: a key defined twice is an authoring
        # error, not an override
        dup = sorted(set(base_cfg) & set(merged))
        if dup:
            raise KeyError(
                f"duplicate keys across _base_ files of {filepath}: {dup}")
        merged = merge_dict(base_cfg, merged)
    return merge_dict(cfg, merged)


class Config(ConfigDict):
    """A fully-resolved configuration."""

    @classmethod
    def from_file(cls, filepath: str) -> "Config":
        out = cls(load_yaml_with_base(filepath))
        out["config_path"] = osp.abspath(filepath)
        out["exp"] = osp.splitext(osp.basename(filepath))[0]
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, default_flow_style=False,
                           sort_keys=False)


def get_train_config(argv: Optional[List[str]] = None) -> Config:
    """The train CLI's config: the flags of the JAX package's
    ``get_train_config`` (the reference's TrainConfig.get_opt, short
    aliases included), laid over the YAML, with ``opt.path`` filled.
    ``-d`` names the torch device (the GPU unless ``cpu`` is given)."""
    parser = argparse.ArgumentParser(description="train")
    parser.add_argument("config_path", type=str, help="path to YAML config")
    parser.add_argument("-d", "--device", type=str, default=None,
                        help="torch device: cuda (the default) or cpu")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("-si", "--start_iter", type=int, default=None)
    parser.add_argument("-ti", "--total_iter", type=int, default=None)
    parser.add_argument("-b", "--batch_size", type=int, default=None)
    parser.add_argument("-e", "--eval_step", type=int, default=None)
    parser.add_argument("-l", "--log_step", type=int, default=None)
    parser.add_argument("-s", "--save_step", type=int, default=None)
    parser.add_argument("-nw", "--num_workers", type=int, default=None)
    parser.add_argument("--n_devices", type=int, default=None,
                        help="data parallel: one rank a device, N ranks")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group that COORDINATOR_ADDRESS"
                             " / NUM_PROCESSES / PROCESS_ID configure")
    parser.add_argument("--auto_resume", action="store_true",
                        help="resume from the newest checkpoint in the "
                             "experiment dir")
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("-wb", "--use_wandb", action="store_true")
    args = parser.parse_args(argv)

    cfg = Config.from_file(args.config_path)
    for key in ("start_iter", "total_iter", "eval_step", "log_step",
                "save_step", "n_devices"):
        val = getattr(args, key)
        if val is not None:
            cfg[key] = val
    if args.batch_size is not None:
        cfg.setdefault("dataset", ConfigDict())
        cfg["dataset"]["batch_size"] = args.batch_size
    if args.num_workers is not None:
        cfg["num_workers"] = args.num_workers
    cfg["device"] = args.device
    cfg["distributed"] = bool(args.distributed)
    cfg["auto_resume"] = bool(args.auto_resume)
    cfg["dry_run"] = bool(args.dry_run)
    cfg["use_wandb"] = bool(args.use_wandb)
    cfg["debug"] = bool(args.debug)
    cfg["is_train"] = True
    cfg.setdefault("start_iter", 0)
    cfg.setdefault("ckpt_root", "./checkpoint")
    cfg["host"] = socket.gethostname()
    fill_paths(cfg)
    return cfg


def fill_paths(cfg: Config) -> None:
    """``cfg.path``: the experiment directory layout (reference
    PathHandler, path.py:13-47)."""
    ckpt_root = cfg.get("ckpt_root", "./checkpoint")
    exp = cfg.get("exp", "exp")
    job_dir = osp.join(ckpt_root, exp)
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    cfg["path"] = ConfigDict(
        ckpt_root=ckpt_root,
        job_dir=job_dir,
        model_dir=osp.join(job_dir, "model"),
        sample_dir=osp.join(job_dir, "sample"),
        log_loss_path=osp.join(job_dir, "log_loss.csv"),
        log_eval_path=osp.join(job_dir, "eval_result.csv"),
        log_file_path=osp.join(job_dir, f"train_{timestamp}.log"),
        config_dump_path=osp.join(job_dir, f"{exp}_dump.yaml"),
    )

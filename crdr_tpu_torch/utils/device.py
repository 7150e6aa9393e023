"""Device resolution and native builds for the port.

Entry points run on the GPU unless the caller asks for the CPU; without a
GPU the default raises instead of carrying on quietly on the CPU.  Native
code (the host rANS coder, the CUDA kernels) is built at first use from the
sources in the package into ``build/crdr_tpu_torch/`` at the repository
root, never next to the sources.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import List, Union

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "crdr_tpu_torch")
_locks_guard = threading.Lock()
_build_locks = {}  # one per output: different libraries build concurrently
_count_lock = threading.Lock()


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means the GPU; raise when it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "crdr_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run it on the CPU")
    return dev


def count_launch(wrapper) -> None:
    """One more launch on ``wrapper.launches``, the kernel wrappers' count;
    under a lock, since the replicas of a serving mesh launch from several
    threads and ``+=`` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1


def package_path(*parts: str) -> str:
    return os.path.join(_PKG_DIR, *parts)


def nvcc_command(source: str) -> List[str]:
    """nvcc invocation for a kernel source: a shared library with a plain C
    interface for sm_90a, the compiler's register / shared-memory report
    (``-Xptxas -v``) kept in the build log."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {os.path.basename(source)} "
                           "is built with it at first use")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", source]


def build_library(name: str, sources: List[str], command: List[str]) -> str:
    """Build ``BUILD_DIR/lib<name>.so`` from ``sources`` unless an
    up-to-date one exists.  ``command`` is the compiler invocation without
    its output path; the build writes a private temporary file and renames it
    into place, so concurrent builds (test workers) never load a half-written
    library.  The compiler's output is kept beside the library as ``.log``."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _locks_guard:
        lock = _build_locks.setdefault(out, threading.Lock())
    with lock:
        newest = max(os.path.getmtime(s) for s in sources)
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            return out
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(command + ["-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(command)}):\n"
                f"{proc.stdout}{proc.stderr}")
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out

"""Several processes, one device each: the process group, the collectives
the trainer needs, and a launcher (counterpart of
``crdr_tpu/parallel/distributed.py``).

JAX runs one SPMD program over every device of a mesh, and XLA inserts the
collectives.  Eager PyTorch runs one process per device (a *rank*) and
calls them itself: the trainer's gradient mean is one ``all_reduce`` of
its optimizer's flat gradient buffer a step, and the few statistics JAX
takes over the global batch (the rate loss's switch, the anomaly skip, the
logs, RaGAN's mean logits) are means over the ranks too.

``init_distributed`` reads what ``jax.distributed.initialize`` reads
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) and starts
``torch.distributed`` with NCCL on the card and gloo on the CPU.  As in
JAX, a coordinator that was configured and cannot be reached raises: a
quiet fall-back to one process would train on 1/N of the data.  ``spawn``
starts ``world_size`` ranks on this machine over a local TCP address, one
per device of a mesh (``--n_devices``, the tests, ``chip_smoke.py``).

NCCL refuses two ranks on one GPU; ranks that share a card run over gloo,
whose all-reduce and broadcast take CUDA tensors.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing as mp
import os
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Device, make_mesh

Tensor = torch.Tensor
logger = logging.getLogger(__name__)
DEFAULT_TIMEOUT_S = 600


def default_backend(device: Device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     init_timeout: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Start the process group from the arguments or the environment
    (``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``,
    ``PROCESS_ID``).  Returns True when several processes take part.  With
    no coordinator there is nothing to join (no cluster tells this machine
    of one) and it returns False; with one that fails, it raises."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env(
        "PROCESS_ID")
    if not coordinator_address:
        logger.debug("no coordinator configured: one process")
        return False
    backend = backend or default_backend(
        "cuda" if torch.cuda.is_available() else "cpu")
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(
                seconds=init_timeout or DEFAULT_TIMEOUT_S))
    except (RuntimeError, ValueError, TypeError) as e:
        # the group was configured explicitly: never carry on alone
        raise RuntimeError(
            f"torch.distributed failed to start for an explicitly "
            f"configured group (coordinator={coordinator_address}, "
            f"num_processes={num_processes}, process_id={process_id}, "
            f"backend={backend})") from e
    logger.info(f"distributed: process {dist.get_rank()} / "
                f"{dist.get_world_size()} ({backend})")
    return dist.get_world_size() > 1


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


# ---------------- the group and its collectives ------------------------------

def active() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def all_reduce_mean_(t: Tensor) -> Tensor:
    """``t`` replaced, in place, by its mean over the ranks (one
    collective; the gradient buffers)."""
    dist.all_reduce(t)
    return t.div_(dist.get_world_size())


def mean_over_ranks(t: Tensor) -> Tensor:
    """A new tensor: ``t``'s mean over the ranks, no gradient (a per-rank
    scalar such as the step's loss)."""
    return all_reduce_mean_(t.detach().clone())


def broadcast_(t: Tensor, src: int = 0) -> Tensor:
    """``t`` replaced, in place, by rank ``src``'s."""
    dist.broadcast(t, src)
    return t


class _MeanOverRanks(torch.autograd.Function):
    """Mean over the ranks with a gradient: the backward takes the mean of
    the incoming gradients too, so that after the optimizer's gradient mean
    each rank's share of the global statistic gets the whole gradient."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_mean_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_mean_(g.clone())


def batch_mean(t: Tensor) -> Tensor:
    """The mean of ``t`` over the global batch (each rank holds an equal
    share of it), differentiable; ``torch.mean`` outside a group."""
    m = torch.mean(t)
    return _MeanOverRanks.apply(m) if active() else m


# ---------------- launching ranks on this machine ----------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(fn, rank_: int, world: int, address: str, backend: str,
              device: str, args, results) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=address, world_size=world, rank=rank_,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        try:
            out = fn(rank_, world, dev, *args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: the result must outlive this process
        results.put((rank_, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank_, False, traceback.format_exc()))
        raise


def spawn(fn: Callable[..., Any], world_size_: int,
          backend: Optional[str] = None,
          devices: Optional[Sequence[Device]] = None,
          args: tuple = ()) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size``
    processes (spawned: no state is inherited), rank r on ``devices[r]``
    (default ``make_mesh(world_size)``: one card each), joined in one
    process group over a local TCP address, ``backend`` NCCL on cards and
    gloo on the CPU by default.  ``fn`` must be importable, and its result
    picklable.  Returns the results in rank order; a rank that fails fails
    the call with its traceback, and every rank is stopped."""
    mesh = make_mesh(world_size_, devices)
    backend = backend or default_backend(mesh[0])
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_run_rank, name=f"crdr-rank{r}", args=(
        fn, r, world_size_, address, backend, str(mesh[r]), args,
        results)) for r in range(world_size_)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        while len(out) + len(errors) < world_size_:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(out) + len(errors) < world_size_:
                    # a rank died before it could report (a signal, the
                    # OOM killer): drain once more, then give up
                    try:
                        r, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank process {dead[0].name} exited with code "
                            f"{dead[0].exitcode} without a result") from None
                else:
                    continue
            if ok:
                out[r] = pickle.loads(payload)
            else:
                errors.append((r, payload))
                break
    finally:
        if errors or len(out) < world_size_:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if errors:
        r, tb = errors[0]
        raise RuntimeError(f"rank {r} of {world_size_} failed:\n{tb}")
    return [out[r] for r in range(world_size_)]

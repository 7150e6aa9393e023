"""Device meshes: an ordered list of devices, and a batch split over it
(counterpart of ``crdr_tpu/parallel/mesh.py``).

JAX places one array over a ``Mesh`` and lets XLA partition the program;
eager PyTorch runs one program per device instead, so a mesh here is the
list of devices those programs run on, and a sharded batch is the list of
its row blocks, one per device, in mesh order.  ``gather`` joins them back
in that order.

A mesh of devices given explicitly may repeat one device (``[cpu] * 4``,
``[cuda:0] * 2``): that is how the tests and ``chip_smoke.py`` run several
"devices" on one CPU or one card, as the JAX package's tests run on 8
virtual CPU devices.  Without a list the mesh is ``cuda:0 .. n-1``, and a
machine with fewer cards raises, as JAX's ``make_mesh`` asserts; nothing
falls back to fewer devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

Tensor = torch.Tensor
Device = Union[str, torch.device]


def make_mesh(n: Optional[int] = None,
              devices: Optional[Sequence[Device]] = None
              ) -> List[torch.device]:
    """The ``n`` devices of a mesh: ``devices`` as given (``n``, when set,
    must be its length), else ``cuda:0 .. n-1``, which must all exist."""
    if devices is not None:
        mesh = [torch.device(d) for d in devices]
        if not mesh or (n is not None and len(mesh) != n):
            raise ValueError(f"a mesh of {n} devices from the list {mesh}")
        return mesh
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else int(n)
    if n < 1 or have < n:
        raise RuntimeError(
            f"a mesh of {n} CUDA devices, and this machine has {have}; "
            "pass an explicit device list to place several ranks or "
            "replicas on one device")
    return [torch.device("cuda", i) for i in range(n)]


def shard_rows(n_rows: int, mesh: Sequence[torch.device]
               ) -> Optional[List[slice]]:
    """The row block of each device for ``n_rows`` rows, in mesh order; None
    when ``n_rows`` does not divide by the mesh size (the batch then runs
    whole on the first device: a choice of speed, never of values)."""
    n = len(mesh)
    if n_rows % n:
        return None
    k = n_rows // n
    return [slice(i * k, (i + 1) * k) for i in range(n)]


def shard_batch(x: Tensor, mesh: Sequence[torch.device], dim: int = 0
                ) -> List[Tensor]:
    """``x`` split along ``dim`` into one block per device, each moved
    there; one block, on the first device, when ``dim`` does not divide."""
    rows = shard_rows(x.shape[dim], mesh)
    if rows is None:
        return [x.to(mesh[0])]
    return [x.narrow(dim, s.start, s.stop - s.start).to(d)
            for s, d in zip(rows, mesh)]


def gather(shards: Sequence[Tensor], dim: int = 0,
           device: Optional[Device] = None) -> Tensor:
    """The blocks of ``shard_batch`` joined in order on ``device`` (default:
    the first block's)."""
    device = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(device) for s in shards], dim)

"""Multi-worker threaded data loader producing NHWC numpy batches
(counterpart of ``crdr_tpu/data/loader.py``, the same order for the same
seed): ``num_workers`` threads load and transform samples, up to
``prefetch`` whole batches stay in flight, and batches are handed out in a
deterministic order while the card runs the previous step.  A sample that
fails to load raises in the consumer.

With ``shard=(rank, world)`` (one rank of a data-parallel run) the loader
walks the global batches of the single-process order and loads rank
``rank``'s block of rows of each, ``batch_size / world`` images; the rows
of the other ranks are only counted as drawn (``dataset.skip``), so every
image's random crop and flip is the one the single process draws.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8,
                 prefetch: int = 4, seed: Optional[int] = None,
                 shard: Tuple[int, int] = (0, 1)):
        self.rank, self.world = shard
        if batch_size % self.world:
            raise ValueError(f"batch_size {batch_size} must be divisible by "
                             f"the {self.world} ranks of the run")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 1)
        self.prefetch = max(prefetch, 1)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            batch = order[start:start + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                return
            if self.world > 1:
                k = len(batch) // self.world
                own = batch[self.rank * k:(self.rank + 1) * k]
                skip = getattr(self.dataset, "skip", None)
                if skip is not None:
                    for i in np.setdiff1d(batch, own):
                        skip(int(i))
                batch = own
            yield batch

    @staticmethod
    def _assemble(futures) -> Dict[str, np.ndarray]:
        samples = [f.result() for f in futures]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if len(self) == 0:
            raise ValueError(
                f"empty loader: dataset has {len(self.dataset)} samples but "
                f"batch_size={self.batch_size} with drop_last={self.drop_last}"
                " — shrink the batch or set the dataset's `repeat` option")
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        errors = []
        pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                  thread_name_prefix="crdr-data")

        def producer():
            try:
                # up to `prefetch` batches' samples load concurrently;
                # batches are assembled and delivered strictly in order
                pending: deque = deque()
                for idxs in self._batch_indices():
                    pending.append([pool.submit(self.dataset.__getitem__,
                                                int(i)) for i in idxs])
                    while len(pending) > self.prefetch:
                        q.put(self._assemble(pending.popleft()))
                while pending:
                    q.put(self._assemble(pending.popleft()))
            except Exception as e:  # handed to the consumer, raised there
                errors.append(e)
            finally:
                q.put(stop)
                pool.shutdown(wait=False)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                if errors:
                    raise errors[0]
                break
            yield item


def cycle(loader: DataLoader, start_iter: int, end_iter: int):
    """Infinite-cycling generator yielding (iter, batch) (reference
    base_trainer.py:120-129)."""
    it = iter(loader)
    for i in range(start_iter, end_iter):
        try:
            data = next(it)
        except StopIteration:
            it = iter(loader)
            data = next(it)
        yield i + 1, data

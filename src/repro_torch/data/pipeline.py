"""Host data pipeline with background prefetch: counterpart of
`repro.data.pipeline`.

A deterministic per-step batch (`batch_fn(step)`) -> this process's slice
of it -> a copy to the training device -> a bounded prefetch queue, so step
N+1's host work and copy overlap step N's compute.

Determinism contract (restarts replay the exact stream): `batch_fn(step)`
is a pure function of the step number. The port runs one process, so its
slice is the whole batch; `host_slice` is kept for the multi-process
layout of the reference.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device

__all__ = ["ShardedPrefetchLoader", "host_slice"]


def host_slice(array, process_index: int, process_count: int):
    """The rows of a global host batch owned by process `process_index`
    of `process_count`; raises unless the rows split evenly."""
    b = array.shape[0]
    if b % process_count:
        raise ValueError(f"{b} rows do not split over {process_count} "
                         f"processes")
    per = b // process_count
    return array[process_index * per:(process_index + 1) * per]


class ShardedPrefetchLoader:
    """Wraps `batch_fn(step) -> dict of arrays or tensors` (the global
    batch) into an iterator of (step, batch on `device`) with `prefetch`
    batches made ahead on a daemon thread. An exception in `batch_fn`
    surfaces in `__next__`. `close()` stops the thread."""

    def __init__(self, batch_fn: Callable[[int], dict], device="cuda",
                 start_step: int = 0, prefetch: int = 2):
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> dict:
        return {k: to_device(v if isinstance(v, torch.Tensor)
                             else np.asarray(v), self.device)
                for k, v in self.batch_fn(step).items()}

    def _put(self, item) -> bool:
        """Queue `item`, giving up once `close()` is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                batch = self._make(s)
            except Exception as e:  # surfaced in __next__
                self._put(e)
                return
            if not self._put((s, batch)):
                return
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the worker and drop the batches it made ahead."""
        self._stop.set()
        self._thread.join(timeout=10)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

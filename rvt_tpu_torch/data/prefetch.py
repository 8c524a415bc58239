"""Background prefetching over batch iterators (a copy of
``rvt_tpu.data.prefetch``).

The reference overlaps storage reads with GPU compute via torch DataLoader
worker processes (hardware.num_workers, modules/data/genx.py:92). Here a
thread pool drives the (numpy, h5py-bound, GIL-releasing) schedulers and a
bounded queue keeps a configurable number of ready batches ahead of the
device step.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

from rvt_tpu_torch.data.types import Batch

_SENTINEL = object()


class PrefetchIterator:
    """Wrap a batch iterable with a background producer thread.

    ``transform`` (optional) runs on each item inside the producer thread —
    the place for host-side preprocessing (e.g. the s2d stem transform,
    ops/s2d.py) so it overlaps device compute instead of sitting on
    the step's critical path."""

    def __init__(self, iterable: Iterable[Batch], prefetch_depth: int = 4,
                 transform=None):
        assert prefetch_depth >= 1
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce,
                                        args=(iterable, transform),
                                        daemon=True)
        self._thread.start()

    def _produce(self, iterable: Iterable[Batch], transform) -> None:
        try:
            for item in iterable:
                if self._stop.is_set():
                    return
                if transform is not None:
                    item = transform(item)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate to consumer
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(_SENTINEL, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        item = self._queue.get()
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so the producer can exit
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

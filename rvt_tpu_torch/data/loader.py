"""Parallel host input pipeline: plan/fetch batch loading over worker pools
(a copy of ``rvt_tpu.data.loader``).

The reference overlaps storage reads with device compute via torch
DataLoader worker *processes*, each owning private stream state
(``hardware.num_workers``, modules/data/genx.py:92) — which is why its
recurrent state must be keyed by worker id. Here the schedulers
(data/streaming.py) already split batch production into a deterministic
*plan* stream and pure per-window *fetch* calls, so parallelism is a pool
detail instead of a scheduling concern:

  * plans are generated serially (cheap index bookkeeping, preserves
    batch order and lane->state mapping exactly),
  * window fetches (blosc-HDF5 decode + augmentation) fan out to a pool,
  * batches are assembled in plan order — the output stream is
    bit-identical to the serial scheduler by construction
    (tests/test_loader.py).

Two pool flavors:
  * ``thread``: ThreadPoolExecutor. h5py releases the GIL around HDF5 IO
    and the blosc filter (first-party C++ plugin, native/h5blosc.cpp or
    the ctypes fallback) decompresses inside that window, so threads
    scale on multi-core hosts without pickling batches between processes.
  * ``process``: ProcessPoolExecutor. Full python-level parallelism (for
    augmentation-heavy train pipelines where numpy work between reads
    holds the GIL). The scheduler is pickled to each worker once
    (Recording drops its h5 handle on pickle and reopens lazily,
    data/sequence.py) and results come back as pickled sample dicts.

Prefetch depth bounds in-flight fetches so memory stays bounded while the
device consumes batches.
"""
from __future__ import annotations

import collections
from concurrent.futures import Executor, ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, List, Optional

from rvt_tpu_torch.data.streaming import WindowPlan, _stack
from rvt_tpu_torch.data.types import Batch

# -- process-mode worker state -------------------------------------------------
# The scheduler is shipped once via the pool initializer (fork or spawn both
# work: Recording.__getstate__ drops h5 handles, workers reopen lazily).
_WORKER_SCHEDULER = None


def _init_worker(scheduler) -> None:
    global _WORKER_SCHEDULER
    _WORKER_SCHEDULER = scheduler


def _fetch_in_worker(plan: WindowPlan) -> dict:
    return _WORKER_SCHEDULER.fetch(plan)


class ParallelBatchLoader:
    """Iterate ``Batch``es from a plan/fetch scheduler with pooled fetches.

    scheduler: TrainStreamScheduler or EvalStreamScheduler (anything with
    ``plan_batches()`` + ``fetch(plan)``).
    num_workers: pool size; 0 = serial (no pool, no reordering risk — the
    degenerate case equals ``iter(scheduler)``).
    mode: 'thread' | 'process'.
    prefetch_batches: how many batches ahead fetches may run.
    transform: optional Batch -> Batch host transform (e.g. the s2d stem
    blocking, ops/s2d.py) applied after stacking, inside the consumer-side
    drain loop (it is one vectorized numpy op; keeping it out of the pool
    avoids pickling the doubled tensor in process mode).
    """

    def __init__(self, scheduler, num_workers: int = 0, mode: str = "thread",
                 prefetch_batches: int = 4, transform=None):
        assert mode in ("thread", "process"), mode
        assert num_workers >= 0 and prefetch_batches >= 1
        self.scheduler = scheduler
        self.num_workers = num_workers
        self.mode = mode
        self.prefetch_batches = prefetch_batches
        self.transform = transform
        self._pool: Optional[Executor] = None

    def _make_pool(self) -> Executor:
        if self.mode == "thread":
            return ThreadPoolExecutor(max_workers=self.num_workers,
                                      thread_name_prefix="rvt-fetch")
        return ProcessPoolExecutor(max_workers=self.num_workers,
                                   initializer=_init_worker,
                                   initargs=(self.scheduler,))

    def __len__(self) -> int:
        return len(self.scheduler)

    def __iter__(self) -> Iterator[Batch]:
        if self.num_workers == 0:
            for batch in self.scheduler:
                yield batch if self.transform is None else self.transform(batch)
            return
        pool = self._make_pool()
        fetch = (self.scheduler.fetch if self.mode == "thread"
                 else _fetch_in_worker)
        pending = collections.deque()  # [(futures per lane)] in batch order
        try:
            plan_iter = self.scheduler.plan_batches()
            while True:
                while len(pending) < self.prefetch_batches:
                    plans = next(plan_iter, None)
                    if plans is None:
                        break
                    pending.append([pool.submit(fetch, p) for p in plans])
                if not pending:
                    return
                futs = pending.popleft()
                batch = _stack([f.result() for f in futs])
                yield batch if self.transform is None else self.transform(batch)
        finally:
            for futs in pending:
                for f in futs:
                    f.cancel()
            pool.shutdown(wait=False, cancel_futures=True)


def make_loader(scheduler, num_workers: int = 0, mode: str = "thread",
                prefetch_batches: int = 4, transform=None):
    """Convenience: num_workers == 0 returns the bare scheduler iterable
    (optionally transformed) — zero overhead for the serial path."""
    if num_workers == 0 and transform is None:
        return scheduler
    return ParallelBatchLoader(scheduler, num_workers, mode,
                               prefetch_batches, transform)

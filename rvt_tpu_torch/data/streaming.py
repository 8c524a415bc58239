"""Stream scheduling: recordings -> batch lanes -> Batch windows (a copy
of ``rvt_tpu.data.streaming``).

Re-design of the reference's torchdata plumbing:
  * train: ``ConcatStreamingDataPipe`` (stream_concat_datapipe.py:25-103) —
    per worker, ``batch_size`` independent infinite streams, each a
    reshuffled concatenation of all recordings.
  * eval: ``ShardedStreamingDataPipe`` (stream_sharded_datapipe.py:10-94) —
    recordings dealt to workers/lanes with fully-padded fill windows so all
    lanes emit the same number of windows.

Here each *batch lane* owns a queue of stream views and recurrent state is
keyed by lane index (deterministic, mesh-shardable) instead of dataloader
worker id — cleaner than the reference's worker-keyed RNNStates registry
(modules/utils/detection.py:76-130).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from rvt_tpu_torch.data.sequence import StreamView
from rvt_tpu_torch.data.types import Batch


@dataclass(frozen=True)
class WindowPlan:
    """One lane's window for one batch, fully determined ahead of IO.

    The schedulers split batch production into a cheap deterministic *plan*
    stream (pure index bookkeeping, this type) and a *fetch* step (HDF5
    read + augmentation) so fetches can run in a worker pool
    (data/loader.py) while batch order and contents stay bit-identical to
    the serial path. Replaces the reference's coupling of stream state to
    DataLoader worker processes (stream_concat_datapipe.py:62-103).

    ``window_idx == -1`` denotes a fully-padded fill window (eval tail,
    stream_sharded_datapipe.py:49-67). ``aug_seed`` seeds input-dependent
    augmentation draws (random-mode zoom-in box choice) so fetch stays
    pure. ``source`` routes between sub-schedulers (MixedScheduler).
    """
    stream_idx: int
    window_idx: int
    aug_state: Any = None
    aug_seed: Optional[int] = None
    source: int = 0


def _stack(dicts: Sequence[dict], worker_id: int = 0) -> Batch:
    return Batch(
        ev_repr=np.stack([d["ev_repr"] for d in dicts]).transpose(0, 1, 3, 4, 2),
        labels=np.stack([d["labels"] for d in dicts]),
        label_mask=np.stack([d["label_mask"] for d in dicts]),
        frame_valid=np.stack([d["frame_valid"] for d in dicts]),
        is_first_sample=np.stack([d["is_first_sample"] for d in dicts]),
        is_padded=np.stack([d["is_padded"] for d in dicts]),
        worker_id=worker_id,
    )


class TrainStreamScheduler:
    """Infinite mixed stream batches for training.

    Each lane cycles through an independently shuffled permutation of all
    stream views; when a lane's current view is exhausted the next one
    starts with ``is_first_sample=True``. Matches the semantics of the
    reference's per-worker Zipper of shuffled Concater pipes
    (stream_concat_datapipe.py:62-103) without the worker indirection.
    """

    def __init__(self, streams: Sequence[StreamView], batch_size: int,
                 seed: int = 0, augment_fn=None):
        assert len(streams) > 0
        self.streams = list(streams)
        self.batch_size = batch_size
        self.augment_fn = augment_fn
        self._rngs = [random.Random(seed * 7919 + lane) for lane in range(batch_size)]
        self._orders: List[List[int]] = [[] for _ in range(batch_size)]
        self._cur: List[Optional[Iterator]] = [None] * batch_size
        self._augment_state = [None] * batch_size

    def _next_view_iter(self, lane: int):
        if not self._orders[lane]:
            order = list(range(len(self.streams)))
            self._rngs[lane].shuffle(order)
            self._orders[lane] = order
        view_idx = self._orders[lane].pop()
        if self.augment_fn is not None:
            # re-randomize augmentation once per stream
            # (RandAugmentIterDataPipe, sequence_for_streaming.py:205-208)
            self._augment_state[lane] = self.augment_fn.sample_state(
                self._rngs[lane], allow_zoom_in=False)
        return iter(range(len(self.streams[view_idx]))), view_idx

    def plan_batches(self) -> Iterator[List[WindowPlan]]:
        """Deterministic plan stream: which (stream, window, augmentation)
        each lane draws next. All randomness (per-lane permutations,
        per-stream augment re-rolls) happens here; ``fetch`` is pure."""
        iters = [None] * self.batch_size
        view_idx = [0] * self.batch_size
        while True:
            plans = []
            for lane in range(self.batch_size):
                while True:
                    if iters[lane] is None:
                        iters[lane], view_idx[lane] = self._next_view_iter(lane)
                    try:
                        idx = next(iters[lane])
                        break
                    except StopIteration:
                        iters[lane] = None
                plans.append(WindowPlan(view_idx[lane], idx,
                                        self._augment_state[lane]))
            yield plans

    def fetch(self, plan: WindowPlan) -> dict:
        """IO + augmentation for one plan — pure in the plan (safe to run
        in any worker, in any order)."""
        sample = self.streams[plan.stream_idx][plan.window_idx]
        if self.augment_fn is not None and plan.aug_state is not None:
            sample = self.augment_fn.apply(sample, plan.aug_state)
        return sample

    def __iter__(self) -> Iterator[Batch]:
        for plans in self.plan_batches():
            yield _stack([self.fetch(p) for p in plans])


class EvalStreamScheduler:
    """Deterministic full-coverage evaluation batches.

    Deals recordings to lanes longest-first onto the currently shortest
    lane (balanced makespan), then zips lanes into batches, drawing
    fully-padded fill windows from exhausted lanes until every lane is
    drained — the same coverage guarantee as the reference's pyramid
    round-robin + ZipperLongest (stream_sharded_datapipe.py:31-67).

    ``shard_index``/``num_shards`` split recordings across data-parallel
    processes (reference: rank * num_workers + worker id, 73-80).
    """

    def __init__(self, streams: Sequence[StreamView], batch_size: int,
                 shard_index: int = 0, num_shards: int = 1):
        assert num_shards >= 1 and 0 <= shard_index < num_shards
        streams = sorted(streams, key=len, reverse=True)
        self.streams = streams[shard_index::num_shards]
        # lanes hold indices into self.streams (so WindowPlans can address
        # them process-independently)
        self.lanes: List[List[int]] = [[] for _ in range(batch_size)]
        lane_loads = np.zeros(batch_size, np.int64)
        for si, view in enumerate(self.streams):
            lane = int(lane_loads.argmin())
            self.lanes[lane].append(si)
            lane_loads[lane] += len(view)
        self.batch_size = batch_size
        self.num_batches = int(lane_loads.max()) if self.streams else 0

    def __len__(self) -> int:
        return self.num_batches

    def plan_batches(self) -> Iterator[List[WindowPlan]]:
        """Deterministic plan stream; fill windows plan as window_idx -1
        against the first stream's recording."""
        if not self.streams:
            return
        for b in range(self.num_batches):
            plans = []
            for lane_streams in self.lanes:
                off = b
                plan = WindowPlan(0, -1)  # exhausted lane: padded fill
                for si in lane_streams:
                    n = len(self.streams[si])
                    if off < n:
                        plan = WindowPlan(si, off)
                        break
                    off -= n
                plans.append(plan)
            yield plans

    def fetch(self, plan: WindowPlan) -> dict:
        view = self.streams[plan.stream_idx]
        if plan.window_idx < 0:
            return view.rec.padded_window(view.seq_len)
        return view[plan.window_idx]

    def __iter__(self) -> Iterator[Batch]:
        for plans in self.plan_batches():
            yield _stack([self.fetch(p) for p in plans])

"""Random-access and mixed-mode training schedulers (a copy of
``rvt_tpu.data.random_access``).

Reference equivalents:
  * ``build_random_access_dataset`` + ``SequenceForRandomAccess``
    (data/genx_utils/dataset_rnd.py, sequence_rnd.py): each sample is the
    seq_len windows *ending at* a labelled frame; LSTM state resets every
    batch (is_first_sample always True),
  * class-frequency ``WeightedRandomSampler`` (dataset_rnd.py:115-149),
  * mixed mode: every step concatenates a stream batch and a random batch
    along the batch axis (``merge_mixed_batches``,
    modules/utils/detection.py:133-161; lane split
    modules/data/genx.py:116-140). Here the split is explicit: the first
    ``n_stream`` lanes carry persistent streams, the rest are random
    samples — recurrent state is still keyed purely by lane index.
"""
from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence

import numpy as np

from rvt_tpu_torch.data.sequence import RandomAccessView
from rvt_tpu_torch.data.streaming import (TrainStreamScheduler, WindowPlan,
                                          _stack)
from rvt_tpu_torch.data.types import Batch


def class_frequency_weights(views: Sequence[RandomAccessView]) -> np.ndarray:
    """Per-sample weights = mean over the sample's classes of
    total/count(class) (mirrors get_weighted_random_sampler,
    dataset_rnd.py:115-149; iterates labels only)."""
    sample_classes: List[np.ndarray] = []
    counts: dict = {}
    for view in views:
        for i in range(len(view)):
            objframe_idx = int(view.valid_objframe_indices[i])
            labels = view.rec.label_store[objframe_idx]
            cls = labels[:, 5].astype(np.int64)
            sample_classes.append(cls)
            for c in np.unique(cls):
                counts[int(c)] = counts.get(int(c), 0) + int((cls == c).sum())
    total = sum(counts.values())
    weights = np.zeros(len(sample_classes))
    for i, cls in enumerate(sample_classes):
        if len(cls) == 0:
            weights[i] = 0.0
            continue
        weights[i] = float(np.mean([total / counts[int(c)] for c in cls]))
    return weights


class RandomAccessScheduler:
    """Infinite batches of randomly sampled label-anchored windows."""

    def __init__(self, views: Sequence[RandomAccessView], batch_size: int,
                 seed: int = 0, weighted: bool = False, augment_fn=None):
        self.views = list(views)
        self.index: List = [(vi, i) for vi, v in enumerate(self.views)
                            for i in range(len(v))]
        assert self.index, "no random-access samples"
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.py_rng = random.Random(seed)
        self.augment_fn = augment_fn
        self.weights: Optional[np.ndarray] = None
        if weighted:
            w = class_frequency_weights(self.views)
            self.weights = w / w.sum()

    def plan_batches(self) -> Iterator[List[WindowPlan]]:
        """Deterministic plan stream (sampling + augment parameter draws);
        ``fetch`` is pure, so batches are identical whether fetched serially
        or by a worker pool (data/loader.py). Input-dependent augmentation
        randomness (zoom-in GT-box choice) is delegated to a per-plan seed."""
        n = len(self.index)
        while True:
            if self.weights is not None:
                picks = self.rng.choice(n, size=self.batch_size, replace=True,
                                        p=self.weights)
            else:
                picks = self.rng.randint(0, n, size=self.batch_size)
            plans = []
            for pick in picks:
                vi, i = self.index[int(pick)]
                state = seed = None
                if self.augment_fn is not None:
                    # random mode: re-randomise per sample (augmentor.py:44-56)
                    state = self.augment_fn.sample_state(self.py_rng,
                                                         allow_zoom_in=True)
                    seed = self.py_rng.getrandbits(48)
                plans.append(WindowPlan(vi, i, state, seed))
            yield plans

    def fetch(self, plan: WindowPlan) -> dict:
        s = dict(self.views[plan.stream_idx][plan.window_idx])
        s["is_first_sample"] = np.asarray(True)  # reset every batch
        if self.augment_fn is not None and plan.aug_state is not None:
            s = self.augment_fn.apply(s, plan.aug_state,
                                      random.Random(plan.aug_seed))
        return s

    def __iter__(self) -> Iterator[Batch]:
        for plans in self.plan_batches():
            yield _stack([self.fetch(p) for p in plans])


class MixedScheduler:
    """Concatenate stream lanes and random lanes into one batch per step.

    Lane layout: [0, n_stream) persistent streams, [n_stream, B) random.
    Equivalent to the reference's merge of the two loader batches
    (merge_mixed_batches) with a deterministic lane split
    (w_stream : w_random of modules/data/genx.py:116-140).
    """

    def __init__(self, stream_scheduler: TrainStreamScheduler,
                 random_scheduler: RandomAccessScheduler):
        self.stream = stream_scheduler
        self.random = random_scheduler

    @property
    def batch_size(self) -> int:
        return self.stream.batch_size + self.random.batch_size

    def plan_batches(self) -> Iterator[List[WindowPlan]]:
        """Zip the sub-schedulers' plans; ``source`` routes fetch back to
        the owning scheduler (stream lanes first, then random lanes —
        merge order of merge_mixed_batches)."""
        from dataclasses import replace

        for sp, rp in zip(self.stream.plan_batches(),
                          self.random.plan_batches()):
            yield sp + [replace(p, source=1) for p in rp]

    def fetch(self, plan: WindowPlan) -> dict:
        return (self.random if plan.source else self.stream).fetch(plan)

    def __iter__(self) -> Iterator[Batch]:
        for plans in self.plan_batches():
            yield _stack([self.fetch(p) for p in plans])


def split_batch_size(total: int, w_stream: float = 1.0, w_random: float = 1.0):
    """Reference lane split (modules/data/genx.py:116-140): stream share
    rounded, both at least 1."""
    n_stream = max(1, min(total - 1, round(total * w_stream / (w_stream + w_random))))
    return n_stream, total - n_stream

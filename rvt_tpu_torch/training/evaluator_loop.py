"""Window outputs -> Prophesee-protocol arrays.

The part of ``rvt_tpu/training/evaluator_loop.py`` the trainer's
train-time detection metrics need; the streaming evaluation loop over
recordings (``run_streaming_eval``) is not ported yet (ROADMAP).
"""
from __future__ import annotations

import numpy as np

from rvt_tpu_torch.data.types import Batch
from rvt_tpu_torch.evaluation.prophesee import (detections_to_structured,
                                                labels_to_structured)


def iter_batch_detections(batch: Batch, dets: np.ndarray,
                          det_valid: np.ndarray, frame_idx: np.ndarray,
                          gval: np.ndarray):
    """Convert one window's step outputs to Prophesee-protocol arrays.

    Yields (lane, t_step, gt, pred) for every labelled frame: gt/pred are
    BBOX_DTYPE structured arrays stamped with the label frame's time
    (reference to_prophesee, io/box_loading.py:58-99)."""
    for b in range(batch.batch_size):
        for k in range(frame_idx.shape[1]):
            if not gval[b, k]:
                continue
            t_step = int(frame_idx[b, k])
            mask = batch.label_mask[b, t_step]
            labels = batch.labels[b, t_step][mask]
            if len(labels) == 0:
                continue
            time_us = int(labels[0, 0])
            gt = labels_to_structured(labels)
            pred = detections_to_structured(dets[b, k], det_valid[b, k],
                                            time_us)
            yield b, t_step, gt, pred

"""Data-layer type vocabulary (a copy of ``rvt_tpu.data.types``; mirror of
upstream ``data/utils/types.py:14-55``), re-designed for static shapes.

The reference passes per-timestep Python lists with ``None`` holes
(``SparselyBatchedObjectLabels``); the steps here take fixed-size arrays
instead. ``Batch`` is the canonical host-side unit fed to the train and
eval steps: everything is a padded numpy array + mask.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np

# Label field order on disk and in Batch.labels (labels.py:13-21)
LABEL_FIELDS = ("t", "x", "y", "w", "h", "class_id", "class_confidence")
L_T, L_X, L_Y, L_W, L_H, L_CLS, L_CONF = range(7)


class DatasetSamplingMode(str, enum.Enum):
    RANDOM = "random"
    STREAM = "stream"
    MIXED = "mixed"


@dataclass
class Batch:
    """One TBPTT window for a batch of stream lanes.

    ev_repr:      [B, T, H, W, C] uint8/int8 event representations
    labels:       [B, T, M, 7] float32 — (t, x, y, w, h, class_id, conf),
                  x/y = top-left corner in input pixels (storage format)
    label_mask:   [B, T, M] bool — True for real labels
    frame_valid:  [B, T] bool — frame has >= 1 label (drives feature gather)
    is_first_sample: [B] bool — lane restarted; reset LSTM states
    is_padded:    [B, T] bool — zero-padded tail frames (stream mode)
    token_mask:   optional [B, T, H/p, W/p] bool at the stage-1 token grid
                  (p = stem patch size, storage resolution): True tokens are
                  replaced by the learned mask token when the model has
                  enable_masking (reference DataType.TOKEN_MASK,
                  modules/detection.py:135-138)
    worker_id:    int — producing worker (metadata only; recurrent state is
                  keyed by batch lane, not worker, unlike the reference)
    """

    ev_repr: np.ndarray
    labels: np.ndarray
    label_mask: np.ndarray
    frame_valid: np.ndarray
    is_first_sample: np.ndarray
    is_padded: np.ndarray
    token_mask: Optional[np.ndarray] = None
    worker_id: int = 0

    @property
    def batch_size(self) -> int:
        return self.ev_repr.shape[0]

    @property
    def seq_len(self) -> int:
        return self.ev_repr.shape[1]

    def validate(self) -> None:
        B, T = self.ev_repr.shape[:2]
        assert self.labels.shape[:2] == (B, T), self.labels.shape
        assert self.labels.shape[-1] == 7
        assert self.label_mask.shape == self.labels.shape[:3]
        assert self.frame_valid.shape == (B, T)
        assert self.is_first_sample.shape == (B,)
        assert self.is_padded.shape == (B, T)
        # a frame marked valid must have at least one label
        assert np.all(self.frame_valid == self.label_mask.any(-1))

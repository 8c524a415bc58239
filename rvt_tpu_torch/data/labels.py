"""Object-label containers as padded numpy arrays (a copy of
``rvt_tpu.data.labels``).

Replaces the reference's tensor-wrapper class hierarchy
(``data/genx_utils/labels.py``: ObjectLabelBase / ObjectLabelFactory /
ObjectLabels / SparselyBatchedObjectLabels) with plain arrays + masks that
batch into static shapes. Geometric ops (flip / rotate / zoom) reproduce
the reference semantics (labels.py:210-339) in vectorised numpy and
operate on ``[N, 7]`` arrays of (t, x, y, w, h, class_id, conf) with x/y
the top-left corner.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from rvt_tpu_torch.data.types import L_CLS, L_H, L_W, L_X, L_Y


def clamp_to_frame(labels: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Clamp boxes into the frame (labels.py:37-50). Returns a copy."""
    ht, wd = hw
    out = labels.copy()
    x0 = np.clip(out[:, L_X], 0, wd - 1)
    y0 = np.clip(out[:, L_Y], 0, ht - 1)
    x1 = np.clip(out[:, L_X] + out[:, L_W], 0, wd - 1)
    y1 = np.clip(out[:, L_Y] + out[:, L_H], 0, ht - 1)
    out[:, L_X], out[:, L_Y] = x0, y0
    out[:, L_W], out[:, L_H] = x1 - x0, y1 - y0
    return out


def remove_flat(labels: np.ndarray) -> np.ndarray:
    keep = (labels[:, L_W] > 0) & (labels[:, L_H] > 0)
    return labels[keep]


def scale(labels: np.ndarray, hw: Tuple[float, float], multiplier: float
          ) -> Tuple[np.ndarray, Tuple[float, float]]:
    """labels.py:316-334. Returns (labels, new_hw)."""
    if multiplier == 1 or len(labels) == 0:
        new_hw = (hw[0] * multiplier, hw[1] * multiplier) if multiplier != 1 else hw
        return labels, new_hw
    new_h, new_w = hw[0] * multiplier, hw[1] * multiplier
    out = labels.copy()
    x1 = np.minimum((out[:, L_X] + out[:, L_W]) * multiplier, new_w - 1)
    y1 = np.minimum((out[:, L_Y] + out[:, L_H]) * multiplier, new_h - 1)
    out[:, L_X] *= multiplier
    out[:, L_Y] *= multiplier
    out[:, L_W] = x1 - out[:, L_X]
    out[:, L_H] = y1 - out[:, L_Y]
    return remove_flat(out), (new_h, new_w)


def flip_lr(labels: np.ndarray, hw: Tuple[float, float]) -> np.ndarray:
    """labels.py:336-339."""
    out = labels.copy()
    out[:, L_X] = hw[1] - 1 - out[:, L_X] - out[:, L_W]
    return out


def rotate(labels: np.ndarray, hw: Tuple[int, int], angle_deg: float) -> np.ndarray:
    """Rotate boxes counter-clockwise about the integer frame centre and
    take the axis-aligned hull (labels.py:210-253)."""
    if len(labels) == 0:
        return labels
    x, y = labels[:, L_X], labels[:, L_Y]
    w, h = labels[:, L_W], labels[:, L_H]
    corners = np.stack([
        np.stack([x, y], 1), np.stack([x + w, y], 1),
        np.stack([x, y + h], 1), np.stack([x + w, y + h], 1),
    ])  # [4, N, 2]
    center = np.array([hw[1] // 2, hw[0] // 2], dtype=np.float64)
    a = math.radians(angle_deg)
    rot = np.array([[math.cos(a), math.sin(a)], [-math.sin(a), math.cos(a)]])
    pts = (corners - center) @ rot.T + center
    height, width = hw
    x0 = np.clip(pts[..., 0].min(0), 0, width - 1)
    y0 = np.clip(pts[..., 1].min(0), 0, height - 1)
    x1 = np.clip(pts[..., 0].max(0), 0, width - 1)
    y1 = np.clip(pts[..., 1].max(0), 0, height - 1)
    out = labels.copy()
    out[:, L_X], out[:, L_Y] = x0, y0
    out[:, L_W], out[:, L_H] = x1 - x0, y1 - y0
    return remove_flat(out)


def zoom_in_and_rescale(labels: np.ndarray, hw: Tuple[int, int],
                        zoom_xy0: Tuple[int, int], zoom_in_factor: float
                        ) -> np.ndarray:
    """labels.py:255-291: crop to the zoom window, then scale back up."""
    if len(labels) == 0 or zoom_in_factor == 1:
        return labels
    z_x0, z_y0 = zoom_xy0
    h_orig, w_orig = hw
    zw_h, zw_w = h_orig / zoom_in_factor, w_orig / zoom_in_factor
    z_x1 = min(z_x0 + zw_w, w_orig - 1)
    z_y1 = min(z_y0 + zw_h, h_orig - 1)
    out = labels.copy()
    x0 = np.clip(out[:, L_X], z_x0, z_x1 - 1)
    y0 = np.clip(out[:, L_Y], z_y0, z_y1 - 1)
    x1 = np.clip(out[:, L_X] + out[:, L_W], z_x0, z_x1 - 1)
    y1 = np.clip(out[:, L_Y] + out[:, L_H], z_y0, z_y1 - 1)
    out[:, L_X] = x0 - z_x0
    out[:, L_Y] = y0 - z_y0
    out[:, L_W] = x1 - x0
    out[:, L_H] = y1 - y0
    out = remove_flat(out)
    out, _ = scale(out, (zw_h, zw_w), zoom_in_factor)
    return out


def zoom_out_and_rescale(labels: np.ndarray, hw: Tuple[int, int],
                         zoom_xy0: Tuple[int, int], zoom_out_factor: float
                         ) -> np.ndarray:
    """labels.py:293-314: shrink, then paste at the given offset."""
    if len(labels) == 0 or zoom_out_factor == 1:
        return labels
    out, _ = scale(labels, hw, 1.0 / zoom_out_factor)
    out = out.copy()
    out[:, L_X] += zoom_xy0[0]
    out[:, L_Y] += zoom_xy0[1]
    return out


def to_yolox_format(labels: np.ndarray) -> np.ndarray:
    """(t,x,y,w,h,cls,conf) -> (class_id, cx, cy, w, h)
    (labels.py:341-355)."""
    out = np.zeros((len(labels), 5), np.float32)
    if len(labels) == 0:
        return out
    out[:, 0] = labels[:, L_CLS]
    out[:, 1] = labels[:, L_X] + 0.5 * labels[:, L_W]
    out[:, 2] = labels[:, L_Y] + 0.5 * labels[:, L_H]
    out[:, 3] = labels[:, L_W]
    out[:, 4] = labels[:, L_H]
    return out


def pad_labels(labels: np.ndarray, max_labels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate [N, 7] -> ([max_labels, 7], mask)."""
    n = min(len(labels), max_labels)
    out = np.zeros((max_labels, 7), np.float32)
    mask = np.zeros((max_labels,), bool)
    out[:n] = labels[:n]
    mask[:n] = True
    return out, mask


@dataclass
class LabelStore:
    """Frame-indexed view over a recording's flat label array.

    Mirrors ``ObjectLabelFactory`` (labels.py:149-198): labels are stored as
    one flat [L, 7] array plus ``objframe_idx_2_label_idx`` offsets; frame i
    owns rows [offsets[i], offsets[i+1]).
    """

    labels: np.ndarray                 # [L, 7] float32
    objframe_idx_2_label_idx: np.ndarray  # [F] int64 start offsets
    input_size_hw: Tuple[int, int]
    downsample_factor: Optional[float] = None

    @staticmethod
    def from_structured_array(arr: np.ndarray, offsets: np.ndarray,
                              input_size_hw: Tuple[int, int],
                              downsample_factor: Optional[float] = None
                              ) -> "LabelStore":
        cols = [arr[k].astype(np.float32) for k in
                ("t", "x", "y", "w", "h", "class_id", "class_confidence")]
        flat = np.stack(cols, axis=1)
        flat = clamp_to_frame(flat, input_size_hw)
        return LabelStore(labels=flat,
                          objframe_idx_2_label_idx=offsets.astype(np.int64),
                          input_size_hw=input_size_hw,
                          downsample_factor=downsample_factor)

    def __len__(self) -> int:
        return len(self.objframe_idx_2_label_idx)

    def __getitem__(self, i: int) -> np.ndarray:
        assert 0 <= i < len(self)
        start = self.objframe_idx_2_label_idx[i]
        end = (self.labels.shape[0] if i == len(self) - 1
               else self.objframe_idx_2_label_idx[i + 1])
        out = self.labels[start:end].copy()
        if self.downsample_factor is not None:
            out, _ = scale(out, self.input_size_hw, 1.0 / self.downsample_factor)
        return out

"""Visualization: event tensors -> RGB images and detection overlays (a
copy of ``rvt_tpu.utils.visualization``).

Covers the reference observability components:
  * event-tensor rendering (callbacks/viz_base.py:163-174),
  * pred/GT box drawing (utils/evaluation/prophesee/visualize/vis_utils.py
    + callbacks/detection.py) — cv2-based.

Panels are written during validation by training/evaluator_loop.py
(``viz_dir=...``); per-parameter gradient-flow logging lives inside the
train step (training/step.py, reference callbacks/gradflow.py:10-51).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

LABELMAP_GEN1 = ("car", "pedestrian")
LABELMAP_GEN4_SHORT = ("pedestrian", "two-wheeler", "car")

_COLORS = ((0, 255, 0), (0, 128, 255), (255, 64, 64))


def ev_repr_to_img(ev_repr: np.ndarray) -> np.ndarray:
    """Stacked-histogram [C=2*bins, H, W] -> RGB uint8.

    Renders polarity dominance like the reference (viz_base.py:163-174):
    white background, red where negative polarity dominates, blue where
    positive dominates.
    """
    assert ev_repr.ndim == 3
    ch = ev_repr.shape[0]
    bins = ch // 2
    neg = ev_repr[:bins].astype(np.int32).sum(0)
    pos = ev_repr[bins:].astype(np.int32).sum(0)
    diff = pos - neg
    img = np.full(ev_repr.shape[1:] + (3,), 114, np.uint8)
    img[diff > 0] = (255, 0, 0)
    img[diff < 0] = (0, 0, 255)
    return img


def draw_bboxes(img: np.ndarray, boxes: np.ndarray,
                labelmap: Sequence[str] = LABELMAP_GEN1,
                color_offset: int = 0) -> np.ndarray:
    """Draw BBOX_DTYPE structured boxes onto an RGB image (vis_utils.py:11+).
    Falls back to plain numpy rectangles if cv2 is unavailable."""
    out = img.copy()
    try:
        import cv2
    except ImportError:
        cv2 = None
    for b in boxes:
        x0, y0 = int(b["x"]), int(b["y"])
        x1, y1 = int(b["x"] + b["w"]), int(b["y"] + b["h"])
        cls = int(b["class_id"])
        color = _COLORS[(cls + color_offset) % len(_COLORS)]
        if cv2 is not None:
            cv2.rectangle(out, (x0, y0), (x1, y1), color, 1)
            name = labelmap[cls] if cls < len(labelmap) else str(cls)
            conf = float(b["class_confidence"])
            cv2.putText(out, f"{name} {conf:.2f}", (x0, max(y0 - 3, 0)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.35, color, 1)
        else:  # 1px numpy rectangle
            h, w = out.shape[:2]
            x0, x1 = np.clip([x0, x1], 0, w - 1)
            y0, y1 = np.clip([y0, y1], 0, h - 1)
            out[y0:y1 + 1, [x0, x1]] = color
            out[[y0, y1], x0:x1 + 1] = color
    return out


def render_detections(ev_repr: np.ndarray, gt_boxes: Optional[np.ndarray],
                      pred_boxes: Optional[np.ndarray],
                      labelmap: Sequence[str] = LABELMAP_GEN1) -> np.ndarray:
    """GT (green-ish) and predictions (offset colors) over the rendered
    event frame (callbacks/detection.py:32-100)."""
    img = ev_repr_to_img(ev_repr)
    if gt_boxes is not None and len(gt_boxes):
        img = draw_bboxes(img, gt_boxes, labelmap, color_offset=0)
    if pred_boxes is not None and len(pred_boxes):
        img = draw_bboxes(img, pred_boxes, labelmap, color_offset=1)
    return img



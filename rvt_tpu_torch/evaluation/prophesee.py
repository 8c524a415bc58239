"""Prophesee evaluation protocol (host-side, numpy; a copy of
``rvt_tpu.evaluation.prophesee``).

Faithful re-implementation of ``utils/evaluation/prophesee/``:
  * box filters (``io/box_filtering.py:18-36``): skip t <= 0.5 s, min box
    diagonal and min side, applied to BOTH GT and predictions
    (``evaluation.py:22-38``),
  * +/-50 ms time-window matching of detections to GT timestamps
    (``metrics/coco_eval.py:55-90``),
  * COCO mAP via rvt_tpu_torch.evaluation.coco (pycocotools is unavailable here),
  * the ``PropheseeEvaluator`` buffer API (``evaluator.py:9-72``).

Class maps: gen1 = (car, pedestrian); gen4 = (pedestrian, two-wheeler, car)
(``evaluation.py:15-19``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rvt_tpu_torch.evaluation.coco import evaluate_coco_map

BBOX_DTYPE = np.dtype({
    "names": ["t", "x", "y", "w", "h", "class_id", "track_id", "class_confidence"],
    "formats": ["<i8", "<f4", "<f4", "<f4", "<f4", "<u4", "<u4", "<f4"],
    "offsets": [0, 8, 12, 16, 20, 24, 28, 32], "itemsize": 40})

CLASSES = {
    "gen1": ("car", "pedestrian"),
    "gen4": ("pedestrian", "two-wheeler", "car"),
}


def filter_boxes(boxes: np.ndarray, skip_ts: int = int(5e5),
                 min_box_diag: int = 60, min_box_side: int = 20) -> np.ndarray:
    """Prophesee protocol filter: keep boxes after the 0.5 s warm-up whose
    diagonal and both sides clear the camera's minimum-size thresholds
    (semantics of box_filtering.py:18-36, expressed as one vectorized
    mask). Box sides use the protocol's squared-diagonal test so no sqrt
    is taken."""
    side_ok = np.minimum(boxes["w"], boxes["h"]) >= min_box_side
    diag2 = boxes["w"].astype(np.float64) ** 2 + boxes["h"].astype(np.float64) ** 2
    return boxes[(boxes["t"] > skip_ts) & side_ok
                 & (diag2 >= float(min_box_diag) ** 2)]


def match_times(all_ts: np.ndarray, gt_boxes: np.ndarray, dt_boxes: np.ndarray,
                time_tol: int = 50000):
    """Window GT/DT per GT timestamp. GT window is the exact timestamp;
    the DT window is +/-time_tol around it (protocol semantics of
    coco_eval.py:55-90, re-expressed as four ``np.searchsorted`` sweeps
    over the time-sorted buffers instead of a per-timestamp pointer walk —
    O((N+M) log) total and vectorized, which matters at test-set scale).

    ``all_ts`` must be ascending and ``gt_boxes``/``dt_boxes`` time-sorted
    (``evaluate_list`` guarantees both)."""
    ts = np.asarray(all_ts, np.int64)
    assert np.all(ts[1:] >= ts[:-1]), "all_ts must be ascending"
    gt_lo = np.searchsorted(gt_boxes["t"], ts, side="left")
    gt_hi = np.searchsorted(gt_boxes["t"], ts, side="right")
    dt_lo = np.searchsorted(dt_boxes["t"], ts - time_tol, side="left")
    dt_hi = np.searchsorted(dt_boxes["t"], ts + time_tol, side="right")
    return ([gt_boxes[lo:hi] for lo, hi in zip(gt_lo, gt_hi)],
            [dt_boxes[lo:hi] for lo, hi in zip(dt_lo, dt_hi)])


def evaluate_list(result_boxes_list: Sequence[np.ndarray],
                  gt_boxes_list: Sequence[np.ndarray],
                  height: int, width: int, camera: str = "gen1",
                  apply_bbox_filters: bool = True,
                  downsampled_by_2: bool = False) -> Dict[str, float]:
    """Protocol entry point (evaluation.py:5-42)."""
    assert camera in CLASSES, camera
    num_classes = len(CLASSES[camera])

    if apply_bbox_filters:
        min_box_diag = 60 if camera == "gen4" else 30
        min_box_side = 20 if camera == "gen4" else 10
        if downsampled_by_2:
            min_box_diag //= 2
            min_box_side //= 2
        gt_boxes_list = [filter_boxes(b, int(5e5), min_box_diag, min_box_side)
                         for b in gt_boxes_list]
        result_boxes_list = [filter_boxes(b, int(5e5), min_box_diag, min_box_side)
                             for b in result_boxes_list]

    flat_gt: List[np.ndarray] = []
    flat_dt: List[np.ndarray] = []
    for gt, dt in zip(gt_boxes_list, result_boxes_list):
        assert np.all(gt["t"][1:] >= gt["t"][:-1]), "GT must be time-sorted"
        assert np.all(dt["t"][1:] >= dt["t"][:-1]), "DT must be time-sorted"
        all_ts = np.unique(gt["t"])
        gw, dw = match_times(all_ts, gt, dt)
        flat_gt += gw
        flat_dt += dw

    num_det = sum(len(d) for d in flat_dt)
    out_keys = ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L")
    if num_det == 0:
        return {k: 0.0 for k in out_keys}

    def to_rows_gt(b: np.ndarray) -> np.ndarray:
        return np.stack([b["x"], b["y"], b["w"], b["h"],
                         b["class_id"].astype(np.float64)], axis=1) \
            if len(b) else np.zeros((0, 5))

    def to_rows_dt(b: np.ndarray) -> np.ndarray:
        return np.stack([b["x"], b["y"], b["w"], b["h"],
                         b["class_id"].astype(np.float64),
                         b["class_confidence"].astype(np.float64)], axis=1) \
            if len(b) else np.zeros((0, 6))

    return evaluate_coco_map([to_rows_gt(g) for g in flat_gt],
                             [to_rows_dt(d) for d in flat_dt],
                             num_classes=num_classes)


def labels_to_structured(labels: np.ndarray) -> np.ndarray:
    """[N, 7] (t,x,y,w,h,cls,conf) float rows -> BBOX_DTYPE structured array
    (mirrors loaded_label_to_prophesee, io/box_loading.py:47-55)."""
    out = np.zeros((len(labels),), BBOX_DTYPE)
    if len(labels):
        out["t"] = labels[:, 0].astype(np.int64)
        out["x"] = labels[:, 1]
        out["y"] = labels[:, 2]
        out["w"] = labels[:, 3]
        out["h"] = labels[:, 4]
        out["class_id"] = labels[:, 5].astype(np.uint32)
        out["class_confidence"] = labels[:, 6]
    return out


def detections_to_structured(det: np.ndarray, valid: np.ndarray,
                             time_us: int) -> np.ndarray:
    """NMS output rows (x1,y1,x2,y2,obj,cls_conf,cls_id) -> BBOX_DTYPE,
    stamped with the label-frame time (io/box_loading.py:81-97)."""
    det = det[valid]
    out = np.zeros((len(det),), BBOX_DTYPE)
    if len(det):
        out["t"] = time_us
        out["x"] = det[:, 0]
        out["y"] = det[:, 1]
        out["w"] = det[:, 2] - det[:, 0]
        out["h"] = det[:, 3] - det[:, 1]
        out["class_id"] = det[:, 6].astype(np.uint32)
        out["class_confidence"] = det[:, 5]
    return out


class PropheseeEvaluator:
    """Accumulates per-frame GT/prediction arrays; evaluate at epoch end
    (mirror of utils/evaluation/prophesee/evaluator.py:9-72)."""

    def __init__(self, dataset: str, downsample_by_2: bool = False):
        assert dataset in CLASSES, dataset
        self.dataset = dataset
        self.downsample_by_2 = downsample_by_2
        self._labels: List[np.ndarray] = []
        self._predictions: List[np.ndarray] = []

    def add_labels(self, labels: Sequence[np.ndarray]) -> None:
        self._labels.extend(labels)

    def add_predictions(self, preds: Sequence[np.ndarray]) -> None:
        self._predictions.extend(preds)

    def has_data(self) -> bool:
        return bool(self._labels)

    def reset_buffer(self) -> None:
        self._labels.clear()
        self._predictions.clear()

    # -- multi-host buffer exchange ----------------------------------------
    # The reference reduces the final mAP across ranks
    # (modules/detection.py:319-334); we instead exchange the raw protocol
    # buffers so every process evaluates the identical full set (same
    # best-checkpoint decision everywhere, no metric averaging skew).

    def state_bytes(self) -> bytes:
        """Serialize the per-frame GT/prediction buffers."""
        import io

        bio = io.BytesIO()
        np.savez(
            bio,
            label_lens=np.asarray([len(a) for a in self._labels], np.int64),
            labels=(np.concatenate(self._labels) if self._labels
                    else np.zeros(0, BBOX_DTYPE)),
            pred_lens=np.asarray([len(a) for a in self._predictions], np.int64),
            preds=(np.concatenate(self._predictions) if self._predictions
                   else np.zeros(0, BBOX_DTYPE)))
        return bio.getvalue()

    def extend_from_bytes(self, payload: bytes) -> None:
        """Append another process's serialized buffers."""
        import io

        data = np.load(io.BytesIO(payload))
        for lens_key, flat_key, target in (
                ("label_lens", "labels", self._labels),
                ("pred_lens", "preds", self._predictions)):
            # field-wise copy: np.save normalizes the aligned/padded
            # BBOX_DTYPE layout (itemsize 40) to the packed equivalent
            flat = data[flat_key].astype(BBOX_DTYPE)
            offsets = np.concatenate(([0], np.cumsum(data[lens_key])))
            target.extend(flat[s:e] for s, e in zip(offsets[:-1], offsets[1:]))

    def evaluate_buffer(self, img_height: int, img_width: int
                        ) -> Optional[Dict[str, float]]:
        if not self.has_data():
            return None
        assert len(self._labels) == len(self._predictions)
        return evaluate_list(
            result_boxes_list=self._predictions,
            gt_boxes_list=self._labels,
            height=img_height, width=img_width,
            camera=self.dataset,
            downsampled_by_2=self.downsample_by_2)

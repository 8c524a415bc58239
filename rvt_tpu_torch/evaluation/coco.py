"""Clean-room COCO bbox mAP evaluator in pure numpy (a copy of
``rvt_tpu.evaluation.coco``; its per-image matcher takes the native C++
fast path of ``rvt_tpu_torch.native_lib`` when the library loads).

pycocotools is not available in this environment, so this implements the
COCOeval 'bbox' protocol directly (same algorithm as the evaluator the
reference invokes at ``utils/evaluation/prophesee/metrics/coco_eval.py:16-22``):

  * IoU thresholds 0.50:0.05:0.95, 101 recall points,
  * area ranges all/small/medium/large ([0,32^2], [32^2,96^2], [96^2,1e5^2]),
  * maxDets = 100 for the headline metrics,
  * greedy per-image matching in descending score order; each detection
    takes the still-unmatched GT with the highest IoU >= threshold,
  * ignored GTs (area out of range) sort last and absorb detections
    without penalty; unmatched detections with out-of-range area are
    ignored as well,
  * AP averaged over categories that have at least one GT.

Verified by fuzzing (200+ random multi-image/multi-class scenes plus
maxDets/area-range/ignored-GT edge cases) against an independent test-only
transcription of the published COCOeval algorithm: tests/test_coco_eval.py
+ tests/coco_oracle.py.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def iou_xywh(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU matrix [D, G] for xywh boxes (== pycocotools maskUtils.iou with
    iscrowd=0)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.maximum(0.0, np.minimum(dx2[:, None], gx2[None]) -
                    np.maximum(dx1[:, None], gx1[None]))
    iy = np.maximum(0.0, np.minimum(dy2[:, None], gy2[None]) -
                    np.maximum(dy1[:, None], gy1[None]))
    inter = ix * iy
    area_d = dt[:, 2] * dt[:, 3]
    area_g = gt[:, 2] * gt[:, 3]
    union = area_d[:, None] + area_g[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_img(ious: np.ndarray, gt_ignore: np.ndarray,
               dt_out_of_range: np.ndarray):
    """Greedy per-image matching across all IoU thresholds. ``ious`` must
    already have its GT columns sorted non-ignored-first (stable), like
    pycocotools' gtind sort. Returns (dt_matched [T, D], dt_ignored [T, D]).
    """
    D, G = ious.shape
    T = len(IOU_THRS)

    # fast path: native greedy matcher (C++ equivalent of detectron2's
    # COCOeval_opt; see native/rvt_native.cpp)
    from rvt_tpu_torch import native_lib

    native = native_lib.coco_match_image(ious, gt_ignore, IOU_THRS,
                                         dt_out_of_range) if D else None
    if native is not None:
        return native

    dt_m = np.full((T, D), -1, np.int64)
    gt_m = np.full((T, G), -1, np.int64)
    for ti, t in enumerate(IOU_THRS):
        thr = min(t, 1 - 1e-10)
        for d in range(D):
            best_iou = thr
            best_g = -1
            for g in range(G):
                if gt_m[ti, g] >= 0:
                    continue
                # best non-ignored match found and this gt is ignored -> stop
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g >= 0:
                dt_m[ti, d] = best_g
                gt_m[ti, best_g] = d

    dt_ig = np.zeros((T, D), bool)
    for ti in range(T):
        matched = dt_m[ti] >= 0
        matched_ignored = np.zeros(D, bool)
        matched_ignored[matched] = gt_ignore[dt_m[ti, matched]]
        dt_ig[ti] = np.where(matched, matched_ignored,
                             dt_out_of_range)
    return dt_m >= 0, dt_ig


def evaluate_coco_map(gts: Sequence[np.ndarray], dts: Sequence[np.ndarray],
                      num_classes: int) -> Dict[str, float]:
    """gts/dts: per-image structured-ish arrays with columns
    (x, y, w, h, class_id[, score]); gt rows [N,5], dt rows [N,6].

    Returns {'AP', 'AP_50', 'AP_75', 'AP_S', 'AP_M', 'AP_L'} (COCO stats
    0-5, the keys the reference logs at coco_eval.py:109).
    """
    assert len(gts) == len(dts)
    num_imgs = len(gts)
    T = len(IOU_THRS)
    R = len(REC_THRS)
    area_items = list(AREA_RANGES.items())
    A = len(area_items)
    # ap[a, t, c]; NaN marks "category absent / no GT" (excluded from means)
    ap = np.full((A, T, num_classes), np.nan)

    for c in range(num_classes):
        # One pass over images per category: detections are score-sorted
        # and the IoU matrix computed ONCE, shared by all four area ranges
        # (pycocotools does the same; the old per-area recompute was 4x
        # the work and dominated at test-set scale).
        has_gt_any = False
        total_gt = np.zeros(A, np.int64)
        all_scores: List[np.ndarray] = []
        all_matched: List[List[np.ndarray]] = [[] for _ in range(A)]
        all_ignored: List[List[np.ndarray]] = [[] for _ in range(A)]
        for i in range(num_imgs):
            gt = gts[i]
            dt = dts[i]
            gt_c = gt[gt[:, 4] == c][:, :4] if len(gt) else np.zeros((0, 4))
            if len(gt_c):
                has_gt_any = True
            dt_rows = dt[dt[:, 4] == c] if len(dt) else np.zeros((0, 6))
            dt_scores = (dt_rows[:, 5] if dt_rows.shape[1] > 5
                         else np.zeros(len(dt_rows)))
            order = np.argsort(-dt_scores, kind="mergesort")[:MAX_DETS]
            dt_boxes = dt_rows[order, :4]
            all_scores.append(dt_scores[order])
            D, G = len(dt_boxes), len(gt_c)
            gt_area = gt_c[:, 2] * gt_c[:, 3] if G else np.zeros(0)
            dt_area = dt_boxes[:, 2] * dt_boxes[:, 3] if D else np.zeros(0)
            ious = iou_xywh(dt_boxes, gt_c)
            for a, (_, rng) in enumerate(area_items):
                gt_ignore = (gt_area < rng[0]) | (gt_area > rng[1])
                total_gt[a] += int((~gt_ignore).sum())
                dt_oor = (dt_area < rng[0]) | (dt_area > rng[1])
                # non-ignored GTs first (stable), like pycocotools gtind
                gt_order = np.argsort(gt_ignore, kind="mergesort")
                m, ig = _match_img(ious[:, gt_order], gt_ignore[gt_order],
                                   dt_oor)
                all_matched[a].append(m)
                all_ignored[a].append(ig)
        if not has_gt_any:
            continue  # category absent entirely -> NaN (excluded)
        scores = np.concatenate(all_scores)
        order = np.argsort(-scores, kind="mergesort")
        for a in range(A):
            if total_gt[a] == 0:
                continue
            matched = np.concatenate(all_matched[a], axis=1)[:, order]
            ignored = np.concatenate(all_ignored[a], axis=1)[:, order]
            tps = matched & ~ignored
            fps = ~matched & ~ignored
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            N = tp_cum.shape[1]
            if N == 0:
                ap[a, :, c] = 0.0
                continue
            rc = tp_cum / total_gt[a]                       # [T, N]
            pr = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
            # monotone precision envelope: reverse running max (the old
            # per-detection python loop was O(T * N) interpreter work)
            pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
            for ti in range(T):
                inds = np.searchsorted(rc[ti], REC_THRS, side="left")
                q = np.where(inds < N, pr[ti][np.minimum(inds, N - 1)], 0.0)
                ap[a, ti, c] = q.mean()

    results: Dict[str, float] = {}
    for a, (area_name, _) in enumerate(area_items):
        ap_t = ap[a]
        valid = ~np.isnan(ap_t)
        mean_ap = ap_t[valid].mean() if valid.any() else 0.0
        if area_name == "all":
            results["AP"] = float(mean_ap)
            v50 = ~np.isnan(ap_t[0])
            results["AP_50"] = float(ap_t[0][v50].mean()) if v50.any() else 0.0
            v75 = ~np.isnan(ap_t[5])
            results["AP_75"] = float(ap_t[5][v75].mean()) if v75.any() else 0.0
        else:
            results[f"AP_{area_name[0].upper()}"] = float(mean_ap)
    for k in ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L"):
        results.setdefault(k, 0.0)
    return results

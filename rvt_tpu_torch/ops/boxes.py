"""Box utilities and the static-shape, on-device NMS postprocess.

Port of ``rvt_tpu/ops/boxes.py``: confidence filter, top-k pre-selection,
class-aware greedy NMS and final top-k, all on the model's device with
fixed output shapes ([B, max_detections, 7] + a validity mask).
Semantics match torchvision's ``batched_nms``: boxes in descending score
order, suppressed when the IoU with an already-kept same-class box is
strictly above the threshold.

On a card the keep mask is the hand-written kernel ``csrc/nms_keep.cu``
(``nms_keep``), which bounds its work by each frame's valid count on the
device, so no step reads the device from the host. Inside a step whose
layers are collected (``utils/timers.py``: a capture, a traced eager
step) that count is the counter ``nms_candidates``, which the kernel
writes into a buffer of the step's. Its plain version,
on the CPU and with ``plain=True``, is the JAX package's Jacobi fixpoint
with its 512-candidate branch, which read flags on the host.

``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk`` does not
promise an order, so the port selects with a stable descending sort.
"""
from __future__ import annotations

from typing import Tuple

import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.kernels import (Counter, check, check_operands, need,
                                       ptr, stream_ptr)
from rvt_tpu_torch.utils import timers

NMS_KEEP = Counter("nms_keep")
# boxes a frame ``csrc/nms_keep.cu`` takes: its alive flags (one byte a
# box) fit the 48 KB of shared memory a block gets without an attribute
NMS_MAX_BOXES = 48 * 1024 - 64


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., N, M] for xyxy boxes (== torchvision box_iou);
    leading dims batch."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.where(union > 0, union, torch.ones_like(union))


def pairwise_iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., N, M] for cxcywh boxes (``bboxes_iou(xyxy=False)``,
    yolox ``utils/boxes.py:79-102``); leading dims batch. An empty
    intersection counts 0; a zero union divides by 1. Areas are w * h
    written out: ``torch.prod``'s backward runs a cumulative-product scan
    that took 28% of the train step's device time."""
    a_tl = a[..., :, None, :2] - a[..., :, None, 2:] / 2
    b_tl = b[..., None, :, :2] - b[..., None, :, 2:] / 2
    a_br = a[..., :, None, :2] + a[..., :, None, 2:] / 2
    b_br = b[..., None, :, :2] + b[..., None, :, 2:] / 2
    tl = torch.maximum(a_tl, b_tl)
    br = torch.minimum(a_br, b_br)
    en = (tl < br).all(-1).to(a.dtype)
    wh = br - tl
    inter = wh[..., 0] * wh[..., 1] * en
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.where(union != 0, union, torch.ones_like(union))


# Jacobi rounds of ``nms_keep_plain`` (each one reads its flag on the
# host), summed over calls; read by the chip check's eval breakdown
NMS_STATS = {"calls": 0, "rounds": 0}


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask [B, K] over score-sorted boxes [B, K, 4].

    Greedy keep is the unique fixpoint of
        keep[i] = valid[i] and not any(j < i: M[j, i] and keep[j]),
    reached by Jacobi iteration of the whole vector (the JAX package's
    ``while_loop``); every round reads the convergence flag on the host."""
    K = boxes.shape[-2]
    iou = pairwise_iou_xyxy(boxes, boxes)
    idx = torch.arange(K, device=boxes.device)
    earlier = idx[:, None] < idx[None, :]
    M = (iou > iou_threshold) & earlier  # M[j, i]: kept j suppresses i

    def f(k: torch.Tensor) -> torch.Tensor:
        return valid & ~torch.any(M & k[..., :, None], dim=-2)

    prev, keep = valid, f(valid)
    it = 0
    while bool(torch.any(keep != prev)) and it < K:
        prev, keep = keep, f(keep)
        it += 1
    NMS_STATS["calls"] += 1
    NMS_STATS["rounds"] += it + 1
    return keep


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
             *, plain: bool = False) -> torch.Tensor:
    """``nms_keep_plain``'s mask: on a CUDA tensor the kernel
    ``csrc/nms_keep.cu`` (one block a frame, a greedy sweep up to the last
    valid box, no host read), else the plain version. boxes [B, K, 4] f32
    (score-sorted, class-offset), valid [B, K] bool; the threshold is
    rounded to f32 as the plain version's comparison rounds it. Inside a
    step whose layers are collected, each frame's valid boxes are counted
    as ``nms_candidates``."""
    if plain or not boxes.is_cuda:
        if timers.collecting():
            timers.count("nms_candidates", valid.sum(-1))
        return nms_keep_plain(boxes, valid, iou_threshold)
    B, K = valid.shape
    check_operands("nms_keep", boxes, valid)
    need(boxes.dtype == torch.float32 and tuple(boxes.shape) == (B, K, 4)
         and valid.dtype == torch.bool and K <= NMS_MAX_BOXES,
         f"nms_keep: boxes f32 [B, K, 4], valid bool [B, K], K <= "
         f"{NMS_MAX_BOXES}")
    keep = torch.empty_like(valid)
    count = (torch.empty(B, dtype=torch.int32, device=valid.device)
             if timers.collecting() else None)
    err = kernels.lib("nms_keep").rvt_nms_keep(
        ptr(boxes), ptr(valid), ptr(keep),
        None if count is None else ptr(count), B, K, iou_threshold,
        stream_ptr(boxes))
    check(err, "nms_keep")
    NMS_KEEP.launches += 1
    if count is not None:
        timers.count("nms_candidates", count)
    return keep


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, ties by index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, A, ...] at idx [B, K] along axis 1."""
    shape = idx.shape + (1,) * (x.dim() - 2)
    return torch.gather(x, 1, idx.reshape(shape).expand(
        idx.shape + x.shape[2:]))


def _postprocess_k(pred: torch.Tensor, k: int, num_classes: int,
                   conf_thre: float, nms_thre: float, max_detections: int,
                   class_agnostic: bool, plain: bool):
    B = pred.shape[0]
    boxes = cxcywh_to_xyxy(pred[..., :4])
    obj = pred[..., 4]
    cls_probs = pred[..., 5:5 + num_classes]
    class_conf = cls_probs.amax(dim=-1)
    class_id = cls_probs.argmax(dim=-1).float()  # first maximum, as jnp
    score = obj * class_conf
    valid = score >= conf_thre

    neg_inf = torch.full_like(score, float("-inf"))
    top_score, top_idx = _top_k(torch.where(valid, score, neg_inf), k)
    top_valid = torch.isfinite(top_score)
    top_boxes = _gather(boxes, top_idx)
    top_cls = _gather(class_id, top_idx)

    if class_agnostic:
        nms_boxes = top_boxes
    else:
        # torchvision batched_nms trick: offset boxes per class
        masked = torch.where(top_valid[..., None], top_boxes,
                             torch.zeros_like(top_boxes))
        max_coord = masked.reshape(B, -1).amax(dim=-1)
        offset = top_cls * (max_coord[:, None] + 1.0)
        nms_boxes = top_boxes + offset[..., None]

    keep = nms_keep(nms_boxes, top_valid, nms_thre, plain=plain)

    kept_score = torch.where(keep, top_score, torch.full_like(top_score,
                                                              float("-inf")))
    m = min(max_detections, k)
    fin_score, fin_idx = _top_k(kept_score, m)
    fin_valid = torch.isfinite(fin_score)
    det = torch.cat([
        _gather(top_boxes, fin_idx),
        _gather(_gather(obj, top_idx), fin_idx)[..., None],
        _gather(_gather(class_conf, top_idx), fin_idx)[..., None],
        _gather(top_cls, fin_idx)[..., None],
    ], dim=-1)
    det = torch.where(fin_valid[..., None], det, torch.zeros_like(det))
    if m < max_detections:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_detections - m))
        fin_valid = torch.nn.functional.pad(fin_valid,
                                            (0, max_detections - m))
    return det, fin_valid


@torch.no_grad()
def postprocess(prediction: torch.Tensor, num_classes: int,
                conf_thre: float = 0.7, nms_thre: float = 0.45,
                pre_nms_topk: int = 1000, max_detections: int = 300,
                class_agnostic: bool = False, *, plain: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched confidence filter + class-aware NMS on device.

    prediction: [B, A, 5+C] decoded cxcywh boxes, obj prob, class probs.
    ``pre_nms_topk > 0``: only the top-k boxes by score enter NMS.
    ``pre_nms_topk <= 0``: every anchor enters NMS (reference semantics).
    On a card (not ``plain``) all A anchors are sorted and ``nms_keep``
    stops at each frame's valid count; the plain version takes the
    top-512 candidate set whenever no lane has more than 512 boxes above
    the threshold, which is exactly the all-anchor result (boxes never
    kept never suppress), and the full set otherwise (a host read).

    Returns (detections [B, max_detections, 7] ordered (x1, y1, x2, y2,
    obj_conf, class_conf, class_id), valid [B, max_detections])."""
    A = prediction.shape[1]
    args = (num_classes, conf_thre, nms_thre, max_detections, class_agnostic,
            plain)
    if pre_nms_topk > 0:
        return _postprocess_k(prediction, min(pre_nms_topk, A), *args)
    fast_k = min(512, A)
    if fast_k == A or (prediction.is_cuda and not plain):
        return _postprocess_k(prediction, A, *args)
    obj = prediction[..., 4]
    class_conf = prediction[..., 5:5 + num_classes].amax(dim=-1)
    n_valid_max = int((obj * class_conf >= conf_thre).sum(dim=-1).max())
    k = A if n_valid_max > fast_k else fast_k
    return _postprocess_k(prediction, k, *args)

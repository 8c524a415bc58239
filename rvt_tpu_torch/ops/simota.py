"""SimOTA dynamic label assignment with fixed shapes, batched over frames.

Port of ``rvt_tpu/ops/simota.py`` (upstream ``yolo_head.py``
``get_assignments`` 452-541, ``get_geometry_constraint`` 543-572,
``simota_matching`` 574-606): ground truths padded to M with a mask, the
candidate filter as a penalty, the dynamic-k top-k as a static top-10 and
a rank < k mask, anchors matched to several GTs resolved to the cheapest.
The JAX ``vmap`` over frames is the leading batch axis here. A traced or
captured step counts the candidate pairs it costs (``simota_pairs``,
``utils/timers.py``).

``jax.lax.top_k`` breaks ties toward the lower index, and sentinel costs
tie by design; ``torch.topk`` promises no order on the card. The selection
here is a stable ascending sort of the cost, which breaks every tie toward
the lower index, as JAX does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from rvt_tpu_torch.ops.boxes import pairwise_iou_cxcywh
from rvt_tpu_torch.utils import timers

_BIG = 1e15  # sentinel cost for excluded (gt, anchor) pairs
_N_CANDIDATE_K = 10  # yolo_head.py:577
_CENTER_RADIUS = 1.5  # yolo_head.py:556


class SimOTAAssignment(NamedTuple):
    fg_mask: torch.Tensor     # [F, A] bool: anchor is a positive
    matched_gt: torch.Tensor  # [F, A] int64: index into the padded GTs
    pred_ious: torch.Tensor   # [F, A] f32: IoU of the matched pair (0 bg)
    num_fg: torch.Tensor      # [F] f32


def simota_assign(pred_boxes: torch.Tensor, obj_logit: torch.Tensor,
                  cls_logit: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, gt_mask: torch.Tensor,
                  grid_xy: torch.Tensor, anchor_strides: torch.Tensor,
                  num_classes: int) -> SimOTAAssignment:
    """Assign GTs to anchors for F frames at once.

    pred_boxes [F, A, 4] decoded cxcywh; obj_logit [F, A]; cls_logit
    [F, A, C]; gt_boxes [F, M, 4] cxcywh (zero padded); gt_classes [F, M]
    int; gt_mask [F, M] bool; grid_xy [A, 2]; anchor_strides [A].
    ``pred_ious`` carries the gradient of the IoU to ``pred_boxes``, as in
    the JAX package (the cost and the matching carry none)."""
    A = pred_boxes.shape[1]
    M = gt_boxes.shape[1]
    f32 = torch.float32

    # ---- geometry constraint (yolo_head.py:543-572) ----
    centers = (grid_xy + 0.5) * anchor_strides[:, None]  # [A, 2]
    center_dist = anchor_strides * _CENTER_RADIUS  # [A]
    lt = gt_boxes[:, :, None, :2] - center_dist[None, None, :, None]
    rb = gt_boxes[:, :, None, :2] + center_dist[None, None, :, None]
    deltas = torch.cat([centers[None, None] - lt, rb - centers[None, None]],
                       dim=-1)
    is_in_center = deltas.amin(-1) > 0.0  # [F, M, A]
    is_in_center = is_in_center & gt_mask[:, :, None]
    anchor_filter = is_in_center.any(1)  # [F, A]
    pair_valid = anchor_filter[:, None, :] & gt_mask[:, :, None]
    # the (gt, anchor) pairs costed below, over the frames: the loss's load
    timers.count("simota_pairs", pair_valid.sum())

    # ---- pairwise IoU & costs (yolo_head.py:493-519) ----
    ious = pairwise_iou_cxcywh(gt_boxes.to(f32), pred_boxes.to(f32))
    ious = torch.where(pair_valid, ious, torch.zeros_like(ious))
    with torch.no_grad():
        iou_loss = -torch.log(ious + 1e-8)
        cls_prob = torch.sqrt(torch.sigmoid(cls_logit.to(f32))
                              * torch.sigmoid(obj_logit.to(f32))[..., None])
        gt_onehot = F.one_hot(gt_classes.long(), num_classes).to(f32)
        p = torch.clamp(cls_prob, 1e-9, 1.0 - 1e-9)[:, None]  # [F,1,A,C]
        y = gt_onehot[:, :, None, :]  # [F, M, 1, C]
        # BCE(p, y) summed over classes, for every (gt, anchor) pair
        cls_loss = -(y * torch.log(p)
                     + (1.0 - y) * torch.log(1.0 - p)).sum(-1)  # [F, M, A]
        cost = cls_loss + 3.0 * iou_loss + 1e6 * (~is_in_center).to(f32)
        cost = torch.where(pair_valid, cost, torch.full_like(cost, _BIG))

        # ---- dynamic k (yolo_head.py:576-579) ----
        k_top = min(_N_CANDIDATE_K, A)
        topk_ious = torch.topk(ious, k_top, dim=-1).values  # [F, M, k]
        dynamic_ks = torch.clamp(topk_ious.sum(-1).to(torch.int32), 1,
                                 k_top)

        # ---- per-GT top-k by smallest cost, ties to the lower index ----
        cost_sorted, order = torch.sort(cost, dim=-1, stable=True)
        top_cost, top_idx = cost_sorted[..., :k_top], order[..., :k_top]
        rank = torch.arange(k_top, device=cost.device)
        select = ((rank[None, None] < dynamic_ks[..., None])
                  & (top_cost < _BIG / 2) & gt_mask[..., None])
        matching = torch.zeros(cost.shape, dtype=torch.bool,
                               device=cost.device)
        matching.scatter_(2, top_idx, select)

        # ---- anchors matched to several GTs (yolo_head.py:588-594) ----
        multiple = matching.sum(1) > 1  # [F, A]
        cost_argmin = cost.argmin(1)  # [F, A], first of equal minima
        keep_row = cost_argmin[:, None, :] == torch.arange(
            M, device=cost.device)[None, :, None]
        matching = torch.where(multiple[:, None, :], keep_row, matching)

        fg_mask = matching.any(1)  # [F, A]
        matched_gt = matching.to(torch.int32).argmax(1)
    pred_ious = (matching.to(f32) * ious).sum(1)
    return SimOTAAssignment(fg_mask=fg_mask, matched_gt=matched_gt,
                            pred_ious=pred_ious,
                            num_fg=fg_mask.to(f32).sum(-1))

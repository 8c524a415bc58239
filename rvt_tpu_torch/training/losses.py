"""YOLOX detection loss with SimOTA assignment, batched over frames.

Port of ``rvt_tpu/training/losses.py`` (upstream ``yolo_head.py:
get_losses`` 291-443): loss = 5 * IoU (1 - iou^2, foreground only) + BCE
(objectness, every anchor of a valid frame) + BCE (classes, foreground),
each divided by the number of foreground anchors of the batch (at least
1). Padded frames and padded GTs are masked out. In data parallelism
(``group``) the batch is the global one, as under JAX's jit over a dp
mesh: the foreground and GT counts are summed over the ranks before the
clamp, and each rank's loss parts are its own sums over the global count
(their sum over the ranks is the global loss).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from rvt_tpu_torch.ops.simota import simota_assign


def iou_cxcywh(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU between [..., 4] cxcywh boxes (losses.py:15-33)."""
    tl = torch.maximum(pred[..., :2] - pred[..., 2:] / 2,
                       target[..., :2] - target[..., 2:] / 2)
    br = torch.minimum(pred[..., :2] + pred[..., 2:] / 2,
                       target[..., :2] + target[..., 2:] / 2)
    area_p = pred[..., 2] * pred[..., 3]  # w * h (see pairwise_iou_cxcywh)
    area_g = target[..., 2] * target[..., 3]
    en = (tl < br).all(-1).to(pred.dtype)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * en
    area_u = area_p + area_g - area_i
    return area_i / (area_u + 1e-16)


def _bce_with_logits(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, elementwise."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def yolox_loss(preds: torch.Tensor, gt_labels: torch.Tensor,
               gt_mask: torch.Tensor, frame_valid: torch.Tensor,
               grid_xy: torch.Tensor, anchor_strides: torch.Tensor,
               num_classes: int, group=None) -> Dict[str, torch.Tensor]:
    """The detection loss over a batch of frames.

    preds [F, A, 5+C] decoded cxcywh + obj/cls logits; gt_labels [F, M, 5]
    (class_id, cx, cy, w, h), zero padded; gt_mask [F, M] bool;
    frame_valid [F] bool (False for gathered padding frames); grid_xy
    [A, 2]; anchor_strides [A]. Returns loss, iou_loss, conf_loss,
    cls_loss and num_fg (foreground anchors per GT), f32 scalars.
    ``group``: the data-parallel process group the counts are summed
    over (None: this batch alone)."""
    f32 = torch.float32
    preds = preds.to(f32)
    boxes = preds[..., :4]
    obj_logit = preds[..., 4]
    cls_logit = preds[..., 5:]
    gt_boxes = gt_labels[..., 1:5].to(f32)
    gt_classes = gt_labels[..., 0].to(torch.int32)
    gt_mask = gt_mask & frame_valid[:, None]

    assign = simota_assign(boxes, obj_logit, cls_logit, gt_boxes, gt_classes,
                           gt_mask, grid_xy, anchor_strides, num_classes)

    fg_f = (assign.fg_mask & frame_valid[:, None]).to(f32)  # [F, A]
    fg_sum, gt_sum = fg_f.sum(), gt_mask.to(f32).sum()
    if group is not None:
        counts = torch.stack([fg_sum, gt_sum])
        dist.all_reduce(counts, group=group)
        fg_sum, gt_sum = counts.unbind(0)
    num_fg = torch.clamp(fg_sum, min=1.0)
    num_gts = torch.clamp(gt_sum, min=1.0)

    # IoU loss (foreground only): 1 - iou^2 (losses.py:36)
    idx = assign.matched_gt.long()
    matched_boxes = torch.gather(gt_boxes, 1,
                                 idx[..., None].expand(-1, -1, 4))
    iou = iou_cxcywh(boxes, matched_boxes)
    loss_iou = ((1.0 - iou ** 2) * fg_f).sum() / num_fg

    # objectness BCE over every anchor of the valid frames
    obj_bce = _bce_with_logits(obj_logit, fg_f)
    loss_obj = (obj_bce * frame_valid[:, None].to(f32)).sum() / num_fg

    # class BCE (foreground), target = one-hot * the matched IoU
    matched_cls = torch.gather(gt_classes, 1, idx).long()
    cls_target = (F.one_hot(matched_cls, num_classes).to(f32)
                  * assign.pred_ious[..., None])
    cls_bce = _bce_with_logits(cls_logit, cls_target)
    loss_cls = (cls_bce.sum(-1) * fg_f).sum() / num_fg

    reg_weight = 5.0
    return {"loss": reg_weight * loss_iou + loss_obj + loss_cls,
            "iou_loss": reg_weight * loss_iou,
            "conf_loss": loss_obj,
            "cls_loss": loss_cls,
            "num_fg": fg_sum / num_gts}

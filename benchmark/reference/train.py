"""The plain reference of one TBPTT training step: the backbone over the
window with gradients, the labelled frames' PAFPN and head with batch
BatchNorm, YOLOX's loss with SimOTA assignment, a global-norm clip, AdamW
and the OneCycle learning rate.

The loss and the assignment follow YOLOX (``yolo_head.py:get_losses``,
``get_assignments``, ``simota_matching``; upstream RVT's
``models/detection/yolox/models``) as the benchmark's configurations
train: foreground anchors inside the 1.5-stride centre radius of a box,
cost = class BCE + 3 x (-log IoU) + 1e6 outside the radius, dynamic k
from the top-10 IoUs, an anchor claimed by several boxes kept by its
cheapest, the IoU loss 1 - IoU^2 weighted 5, objectness BCE over every
anchor of the labelled frames, class BCE against one-hot x IoU, each
divided by the foreground count. The optimizer is optax's clip-by-global-
norm (scale only when the norm reaches the limit) then AdamW (bias
corrections, eps outside the root, decoupled weight decay), the learning
rate two linear segments (warm-up from max / div_factor, then down to max
/ final_div_factor), the first step at count 0.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import rvt
from benchmark.reference.precision import F32, Precision

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def pairwise_iou_cxcywh(a, b):
    """[F, N, 4] x [F, M, 4] -> [F, N, M]; empty intersections count 0."""
    a_tl, a_br = a[..., :, None, :2] - a[..., :, None, 2:] / 2, \
        a[..., :, None, :2] + a[..., :, None, 2:] / 2
    b_tl, b_br = b[..., None, :, :2] - b[..., None, :, 2:] / 2, \
        b[..., None, :, :2] + b[..., None, :, 2:] / 2
    tl, br = torch.maximum(a_tl, b_tl), torch.minimum(a_br, b_br)
    en = (tl < br).all(-1).float()
    inter = (br - tl)[..., 0] * (br - tl)[..., 1] * en
    union = (a[..., 2] * a[..., 3])[..., :, None] \
        + (b[..., 2] * b[..., 3])[..., None, :] - inter
    return inter / torch.where(union != 0, union, torch.ones_like(union))


def simota(boxes, obj_logit, cls_logit, gt_boxes, gt_cls, gt_mask, grid,
           stride, num_classes):
    """Assignment for F frames: (fg [F, A], matched gt [F, A], IoU of the
    matched pair [F, A], carrying the IoU's gradient)."""
    A, M = boxes.shape[1], gt_boxes.shape[1]
    centers = (grid + 0.5) * stride[:, None]
    radius = stride * 1.5
    lt = gt_boxes[:, :, None, :2] - radius[None, None, :, None]
    rb = gt_boxes[:, :, None, :2] + radius[None, None, :, None]
    d = torch.cat([centers[None, None] - lt, rb - centers[None, None]], -1)
    in_center = (d.amin(-1) > 0) & gt_mask[:, :, None]
    pair_ok = in_center.any(1)[:, None, :] & gt_mask[:, :, None]
    ious = pairwise_iou_cxcywh(gt_boxes, boxes)
    ious = torch.where(pair_ok, ious, torch.zeros_like(ious))
    with torch.no_grad():
        p = torch.sqrt(torch.sigmoid(cls_logit)
                       * torch.sigmoid(obj_logit)[..., None])
        p = torch.clamp(p, 1e-9, 1 - 1e-9)[:, None]
        y = F.one_hot(gt_cls.long(), num_classes).float()[:, :, None, :]
        cls_cost = -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).sum(-1)
        cost = cls_cost + 3.0 * -torch.log(ious + 1e-8) \
            + 1e6 * (~in_center).float()
        cost = torch.where(pair_ok, cost, torch.full_like(cost, 1e15))
        k = min(10, A)
        dyn_k = torch.clamp(torch.topk(ious, k, -1).values.sum(-1).int(), 1,
                            k)
        c_sorted, order = torch.sort(cost, dim=-1, stable=True)
        sel = ((torch.arange(k, device=cost.device)[None, None]
                < dyn_k[..., None]) & (c_sorted[..., :k] < 5e14)
               & gt_mask[..., None])
        match = torch.zeros(cost.shape, dtype=torch.bool, device=cost.device)
        match.scatter_(2, order[..., :k], sel)
        several = match.sum(1) > 1
        cheapest = cost.argmin(1)[:, None, :] == torch.arange(
            M, device=cost.device)[None, :, None]
        match = torch.where(several[:, None, :], cheapest, match)
        fg = match.any(1)
        matched = match.int().argmax(1)
    return fg, matched, (match.float() * ious).sum(1)


def _bce(logits, targets):
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def yolox_loss(preds, targets, t_mask, f_valid, grid, stride, num_classes):
    """preds [F, A, 5 + C]; targets [F, M, 5] (class, cx, cy, w, h);
    t_mask [F, M]; f_valid [F]. Returns the loss and its parts."""
    boxes, obj, cls = preds[..., :4], preds[..., 4], preds[..., 5:]
    gt_boxes, gt_cls = targets[..., 1:5], targets[..., 0].long()
    t_mask = t_mask & f_valid[:, None]
    fg, matched, m_iou = simota(boxes, obj, cls, gt_boxes, gt_cls, t_mask,
                                grid, stride, num_classes)
    fg_f = (fg & f_valid[:, None]).float()
    n_fg = torch.clamp(fg_f.sum(), min=1.0)
    n_gt = torch.clamp(t_mask.float().sum(), min=1.0)
    mb = torch.gather(gt_boxes, 1, matched.long()[..., None].expand(-1, -1,
                                                                    4))
    tl = torch.maximum(boxes[..., :2] - boxes[..., 2:] / 2,
                       mb[..., :2] - mb[..., 2:] / 2)
    br = torch.minimum(boxes[..., :2] + boxes[..., 2:] / 2,
                       mb[..., :2] + mb[..., 2:] / 2)
    inter = (br - tl)[..., 0] * (br - tl)[..., 1] * (tl < br).all(-1).float()
    iou = inter / (boxes[..., 2] * boxes[..., 3] + mb[..., 2] * mb[..., 3]
                   - inter + 1e-16)
    l_iou = 5.0 * ((1 - iou ** 2) * fg_f).sum() / n_fg
    l_obj = (_bce(obj, fg_f) * f_valid[:, None].float()).sum() / n_fg
    tgt = F.one_hot(torch.gather(gt_cls, 1, matched.long()), num_classes
                    ).float() * m_iou[..., None]
    l_cls = (_bce(cls, tgt).sum(-1) * fg_f).sum() / n_fg
    return {"loss": l_iou + l_obj + l_cls, "iou_loss": l_iou,
            "conf_loss": l_obj, "cls_loss": l_cls,
            "num_fg": fg_f.sum() / n_gt}


def learning_rate(T: dict, count: int) -> float:
    """OneCycle in float32 at optimizer step ``count`` (0 first)."""
    f32 = np.float32
    max_lr = T["learning_rate"]
    warm = int(T["pct_start"] * T["total_steps"])

    def lin(a, b, steps, c):
        if steps <= 0:
            return float(f32(a))
        c = f32(min(max(c, 0), steps))
        return float(f32(a - b) * (f32(1) - c / f32(steps)) + f32(b))
    if count < warm:
        return lin(max_lr / T["div_factor"], max_lr, warm, count)
    return lin(max_lr, max_lr / T["final_div_factor"],
               T["total_steps"] - warm, count - warm)


class AdamW:
    """Clip by global norm, then AdamW; the moments beside the leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], T: dict):
        self.T = T
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        """Updates ``params`` in place; returns (the raw gradients' norm,
        the clipped gradients the moments took)."""
        T = self.T
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        m = T["gradient_clip_val"]
        scale = m / norm if float(norm) >= m else torch.ones_like(norm)
        clipped = {k: g * scale for k, g in grads.items()}
        n = self.count + 1
        bc1 = 1 - np.float32(B1) ** np.float32(n)
        bc2 = 1 - np.float32(B2) ** np.float32(n)
        lr = learning_rate(T, self.count)
        for k, g in clipped.items():
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            u = (self.mu[k] / float(bc1)) / (torch.sqrt(self.nu[k]
                                                        / float(bc2))
                                             + ADAM_EPS)
            u = u + T["weight_decay"] * params[k]
            params[k] -= lr * u
        self.count = n
        return norm, clipped


def targets_of(labels, label_mask, idx):
    """Storage rows [B, T, M, 7] (t, x, y, w, h, class, ...) at frames idx
    [B, K] -> targets [B*K, M, 5] (class, cx, cy, w, h) and mask."""
    B, K = idx.shape
    lanes = torch.arange(B, device=idx.device)[:, None]
    lab = labels[lanes, idx].reshape(B * K, labels.shape[2], 7).float()
    mask = label_mask[lanes, idx].reshape(B * K, -1)
    return torch.stack([lab[..., 5], lab[..., 1] + lab[..., 3] / 2,
                        lab[..., 2] + lab[..., 4] / 2, lab[..., 3],
                        lab[..., 4]], -1), mask


def train_step(P: Dict[str, torch.Tensor], trainable: List[str], opt: AdamW,
               A: dict, states, ev, labels, label_mask, is_first, K: int,
               prec: Precision = F32):
    """One step on ``P`` (updated in place: the leaves and BatchNorm's
    buffers). ev [B, T, H, W, C] counts. Returns (metrics, the clipped
    gradient per leaf, final states)."""
    leaves = {k: P[k].detach().clone().requires_grad_(True)
              for k in trainable}
    Q = dict(P)
    Q.update(leaves)
    states = rvt.reset(states, is_first)
    x = rvt.pad_events(ev, A).transpose(0, 1)
    feats, final = rvt.backbone_window(Q, A, x, states, prec)
    valid = label_mask.any(-1)
    idx, gval = rvt.gather_labelled(valid, K)
    bn = rvt.BatchNorms(Q, train=True)
    preds = rvt.detect(rvt.gathered(feats, idx), Q, A, bn, prec)
    tg, tm = targets_of(labels, label_mask, idx)
    grid, stride = rvt.anchor_grid(A, preds.device)
    losses = yolox_loss(preds, tg, tm, gval.reshape(-1), grid, stride,
                        A["num_classes"])
    losses["loss"].backward()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    with torch.no_grad():
        params = {k: P[k] for k in trainable}
        norm, clipped = opt.step(params, grads)
        for k, v in bn.updated.items():
            P[k] = v
    metrics = {k: float(v.detach()) for k, v in losses.items()}
    metrics["grad_norm"] = float(norm)
    return metrics, clipped, tuple((h.detach(), c.detach())
                                   for h, c in final)

"""The plain reference of the raw path's voxelizer and of the
detections' postprocess.

``stacked_histogram`` follows upstream RVT's ``StackedHistogram``
(``data/utils/representations.py``, fast mode): each event's time bin is
floor((t - t0) / max(t1 - t0, 1) * bins), clipped to the last bin, with
t0 and t1 the lane's first and last valid timestamps; events outside the
sensor are dropped; counts saturate at 255. ``postprocess`` is YOLOX's
(``models/detection/yolox/utils/boxes.py:postprocess``): score = object
probability x best class probability, a confidence filter, greedy NMS
within each class (a box is suppressed by a kept box of its class whose
IoU exceeds the threshold), the kept boxes by descending score.
"""
from __future__ import annotations

from typing import List

import torch


def stacked_histogram(x, y, p, t, counts, bins: int, H: int, W: int
                      ) -> torch.Tensor:
    """x, y, p, t [B, N] int (zero padded past ``counts`` [B]) ->
    [B, 2 * bins, H, W] uint8 counts, channel = polarity * bins + bin."""
    B, N = x.shape
    out = torch.zeros(B, 2 * bins * H * W, dtype=torch.int64,
                      device=x.device)
    for b in range(B):
        n = int(counts[b])
        if n == 0:
            continue
        xb, yb, pb, tb = (a[b, :n].long() for a in (x, y, p, t))
        t0, t1 = tb[0], tb[-1]
        tn = (tb - t0).float() / torch.clamp(t1 - t0, min=1).float()
        tb_idx = torch.clamp(torch.floor(tn * bins), 0, bins - 1).long()
        keep = (xb >= 0) & (xb < W) & (yb >= 0) & (yb < H) & (pb >= 0) \
            & (pb <= 1)
        idx = ((pb * bins + tb_idx) * H + yb) * W + xb
        out[b] += torch.bincount(idx[keep], minlength=2 * bins * H * W)
    return out.clamp(max=255).to(torch.uint8).reshape(B, 2 * bins, H, W)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    tl = torch.maximum(a[:, None, :2], b[None, :, :2])
    br = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (br - tl).clamp(min=0).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(
        min=1e-12)


def postprocess(preds: torch.Tensor, num_classes: int, conf: float,
                nms: float, max_detections: int) -> List[torch.Tensor]:
    """preds [F, A, 5 + classes] (decoded boxes, logits) -> per frame the
    detections [n, 7] (x1, y1, x2, y2, object prob, class prob, class),
    by descending score, at most ``max_detections``."""
    out = []
    for pr in preds.float():
        obj = torch.sigmoid(pr[:, 4])
        cls_p = torch.sigmoid(pr[:, 5:5 + num_classes])
        cconf, cid = cls_p.amax(-1), cls_p.argmax(-1)  # the first best
        score = obj * cconf
        cand = torch.nonzero(score >= conf).flatten()
        cand = cand[torch.argsort(-score[cand], stable=True)]
        cx, cy, w, h = pr[cand, :4].unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            -1)
        keep = []
        if len(cand):
            iou = _iou(boxes, boxes)
            same = cid[cand][:, None] == cid[cand][None, :]
            alive = torch.ones(len(cand), dtype=torch.bool,
                               device=preds.device)
            for i in range(len(cand)):
                if not alive[i]:
                    continue
                keep.append(i)
                alive &= ~((iou[i] > nms) & same[i])
                alive[i] = False
        keep = torch.tensor(keep[:max_detections], dtype=torch.long,
                            device=preds.device)
        a = cand[keep]
        out.append(torch.cat([boxes[keep], obj[a, None], cconf[a, None],
                              cid[a, None].float()], -1))
    return out

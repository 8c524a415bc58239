"""The model's dense FLOPs, frozen: the numerator of every ``step_mfu``.

A copy of the port's ``utils/flops.py:detector_flops_per_frame`` (itself a
copy of the JAX package's), working from a configuration file's
architecture numbers. Convolutions and matrix products at 2 x MACs;
norms, softmax and elementwise work are not counted. Per event frame:
the backbone (each stage's downsample conv, the window and grid
attention blocks' projections, score and apply einsums and MLP, the
ConvLSTM's 1x1 conv from [x, h]), the PAFPN and the head.

A window or step runs the backbone on all its B x T frames but the PAFPN
and head only on the B x K gathered labelled frames (``step.py``'s
gather); a training step counts three times its forward (forward and
backward, recomputation not counted); a raw call runs the whole detector
on its B frames.
"""
from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3


def _conv(h, w, k, cin, cout):
    return 2 * h * w * k * k * cin * cout


def _csp(h, w, cin, feat, n):
    hidden = feat // 2
    return (2 * _conv(h, w, 1, cin, hidden)
            + n * (_conv(h, w, 1, hidden, hidden)
                   + _conv(h, w, 3, hidden, hidden))
            + _conv(h, w, 1, 2 * hidden, feat))


def _attention_pair(h, w, C, part, r):
    T, n = h * w, part[0] * part[1]
    per_block = (2 * T * C * 3 * C + 2 * 2 * T * n * C + 2 * T * C * C
                 + 2 * 2 * T * C * r * C)
    return 2 * per_block


def per_frame(A: dict) -> Dict[str, float]:
    """FLOPs of one frame: ``backbone``, ``fpn``, ``head``, ``total``."""
    H, W = A["in_res_hw"]
    part = tuple(A["partition_size"])
    dims = [A["embed_dim"] * m for m in A["dim_multiplier"]]
    backbone, hw, c_in, s = 0, {}, A["input_channels"], 1
    for i, C in enumerate(dims):
        f = A["stem_patch_size"] if i == 0 else 2
        s *= f
        h, w = H // s, W // s
        hw[i + 1] = (h, w)
        backbone += _conv(h, w, 2 * f - 1, c_in, C)
        backbone += _attention_pair(h, w, C, part, A["mlp_ratio"])
        backbone += 2 * h * w * 2 * C * 4 * C
        c_in = C
    s2, s1, s0 = A["fpn_in_stages"]
    c2, c1, c0 = dims[s2 - 1], dims[s1 - 1], dims[s0 - 1]
    (h2, w2), (h1, w1), (h0, w0) = hw[s2], hw[s1], hw[s0]
    n = round(3 * A["fpn_depth"])
    fpn = (_conv(h0, w0, 1, c0, c1) + _csp(h1, w1, 2 * c1, c1, n)
           + _conv(h1, w1, 1, c1, c2) + _csp(h2, w2, 2 * c2, c2, n)
           + _conv(h1, w1, 3, c2, c2) + _csp(h1, w1, 2 * c2, c1, n)
           + _conv(h0, w0, 3, c1, c1) + _csp(h0, w0, 2 * c1, c0, n))
    hidden = int(256 * c0 / 1024)
    head = 0
    for (h, w), cin in (((h2, w2), c2), ((h1, w1), c1), ((h0, w0), c0)):
        head += (_conv(h, w, 1, cin, hidden) + 4 * _conv(h, w, 3, hidden,
                                                         hidden)
                 + _conv(h, w, 1, hidden, A["num_classes"] + 5))
    return {"backbone": float(backbone), "fpn": float(fpn),
            "head": float(head), "total": float(backbone + fpn + head)}


def eval_window(A: dict, B: int, T: int, K: int) -> float:
    f = per_frame(A)
    return f["backbone"] * B * T + (f["fpn"] + f["head"]) * B * K


def train_step(A: dict, B: int, T: int, K: int) -> float:
    return 3 * eval_window(A, B, T, K)


def raw_call(A: dict, B: int) -> float:
    return per_frame(A)["total"] * B

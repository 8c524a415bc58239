"""Analytic model FLOPs for the RVT detector (MFU accounting); a copy of
``rvt_tpu/utils/flops.py``, which the port may not import.

Counts dense-compute FLOPs only — convolutions and matmuls at
2 * MACs — the standard MFU numerator; elementwise/norm/softmax work is
excluded (it is bandwidth-, not FLOP-bound, and XLA fuses it into the
dense ops). The walk mirrors the module structure exactly:

  * backbone (models/backbone.py / layers.py): per stage the downsample
    conv (overlap rule: kernel = 2f-1 for factor f), the MaxViT
    attention pair (qkv/proj projections, window+grid score/apply
    einsums, 4x MLP), and the ConvLSTM conv1x1 ([2C] -> [4C]),
  * FPN (models/yolox.py:YoloPAFPN): lateral/reduce 1x1s, four
    CSPLayers (expansion 0.5, n = round(3 * depth) bottlenecks of
    1x1 + 3x3), two stride-2 3x3 bottom-up convs,
  * head (models/yolox.py:YoloXHead): per level a 1x1 stem, 2+2 3x3
    cls/reg convs at hidden = 256 * in_channels[-1]/1024, and the three
    1x1 prediction convs.

The counts are per event frame (batch 1, one timestep). Cross-checked
against XLA's HLO cost analysis in tests/test_model_misc.py. Note
``stem_s2d`` serving inflates the executed stem FLOPs ~1.3x over the
algorithmic 7x7 count (zero-padded taps of the folded 2x2/K=320 kernel);
MFU reports the algorithmic count, matching the reference model.

Reference FLOP surface: maxvit_rnn.py / yolo_pafpn.py / yolo_head.py.
"""
from __future__ import annotations

from typing import Dict, Tuple

from rvt_tpu_torch.config import ModelConfig


def _conv(h: int, w: int, k: int, cin: int, cout: int) -> int:
    """Dense kxk conv at output resolution (h, w): 2 * MACs."""
    return 2 * h * w * k * k * cin * cout


def _csp(h: int, w: int, cin: int, feat: int, n: int) -> int:
    """CSPLayer (expansion 0.5): two 1x1 reductions, n bottlenecks
    (1x1 + 3x3 at hidden width, expansion 1.0), one 1x1 merge."""
    hidden = feat // 2
    total = 2 * _conv(h, w, 1, cin, hidden)
    total += n * (_conv(h, w, 1, hidden, hidden)
                  + _conv(h, w, 3, hidden, hidden))
    total += _conv(h, w, 1, 2 * hidden, feat)
    return total


def _attention_pair(h: int, w: int, C: int,
                    part: Tuple[int, int], mlp_ratio: int) -> int:
    """Window + grid attention blocks: per block qkv ([C]->[3C]) + the
    per-head score/apply einsums (2 x T x N x C each, N = tokens per
    partition) + proj ([C]->[C]) + MLP ([C]->[rC]->[C]). Both partitions
    hold ph * pw tokens: the window block's (ph, pw) windows and the grid
    block's (ph, pw) grids of stride (h / ph, w / pw) (``grid_partition``,
    ``rvt_tpu/models/layers.py:76-83``); the reference's count took
    (h / ph) * (w / pw) for the grid block."""
    T = h * w
    n = part[0] * part[1]  # tokens per partition, window and grid alike
    per_block = (2 * T * C * 3 * C        # qkv
                 + 2 * 2 * T * n * C      # scores + apply
                 + 2 * T * C * C          # proj
                 + 2 * 2 * T * C * mlp_ratio * C)  # fc1 + fc2
    return 2 * per_block


def detector_flops_per_frame(cfg: ModelConfig) -> Dict[str, float]:
    """FLOPs for one full detector forward on ONE event frame:
    backbone timestep (all stages) + PAFPN + head on that frame's
    features. Returns a breakdown dict with 'total'."""
    bb = cfg.backbone
    H, W = bb.in_res_hw
    part = tuple(bb.attention.partition_size)
    dims = bb.stage_dims
    strides = bb.strides

    backbone = 0
    hw = {}
    c_in = bb.input_channels
    for i in range(bb.num_stages):
        f = bb.stem_patch_size if i == 0 else 2
        k = (f - 1) * 2 + 1 if bb.downsample.overlap else f
        h, w = H // strides[i], W // strides[i]
        C = dims[i]
        hw[i + 1] = (h, w)
        backbone += _conv(h, w, k, c_in, C)
        backbone += bb.num_blocks[i] * _attention_pair(
            h, w, C, part, bb.attention.mlp_ratio)
        backbone += 2 * (h * w) * (2 * C) * (4 * C)  # ConvLSTM conv1x1
        c_in = C

    s2, s1, s0 = cfg.fpn.in_stages
    c2, c1, c0 = dims[s2 - 1], dims[s1 - 1], dims[s0 - 1]
    (h2, w2), (h1, w1), (h0, w0) = hw[s2], hw[s1], hw[s0]
    n_csp = round(3 * cfg.fpn.depth)
    fpn = (_conv(h0, w0, 1, c0, c1)            # lateral_conv0
           + _csp(h1, w1, 2 * c1, c1, n_csp)   # C3_p4
           + _conv(h1, w1, 1, c1, c2)          # reduce_conv1
           + _csp(h2, w2, 2 * c2, c2, n_csp)   # C3_p3
           + _conv(h1, w1, 3, c2, c2)          # bu_conv2 (s2, out h1 x w1)
           + _csp(h1, w1, 2 * c2, c1, n_csp)   # C3_n3
           + _conv(h0, w0, 3, c1, c1)          # bu_conv1 (s2, out h0 x w0)
           + _csp(h0, w0, 2 * c1, c0, n_csp))  # C3_n4

    hidden = int(256 * (c0 / 1024))
    ncls = cfg.head.num_classes
    head = 0
    for (h, w), cin in (((h2, w2), c2), ((h1, w1), c1), ((h0, w0), c0)):
        head += _conv(h, w, 1, cin, hidden)                  # stem
        head += 4 * _conv(h, w, 3, hidden, hidden)           # cls/reg convs
        head += _conv(h, w, 1, hidden, ncls + 4 + 1)         # predictions

    total = backbone + fpn + head
    return {"backbone": float(backbone), "fpn": float(fpn),
            "head": float(head), "total": float(total)}

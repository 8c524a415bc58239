"""The least time the card could take for the work the program's
hand-written kernels do, frozen: the numerator of every
``kernels_roofline``.

The work is counted by what the algorithm needs, each input byte read
once and each output byte written once, so that merging or splitting
kernels leaves the count as it is (a copy of ``chip_smoke.py:
stage_bounds``, rows 3 and 8, and its voxelizer and NMS counts):

- a backbone stage over a window (the serving scan: the downsample
  LayerNorm, the window and grid attention blocks, the ConvLSTM over T
  steps): the downsample conv's bf16 output read, the bf16 h sequence
  written, the f32 (h, c) read and written, the bf16 weights read;
  operations 2 x (24 C^2 + 4 n C) a row for the pair (n tokens a
  partition) and 16 C^2 for the cell;
- the same stage trained (forward and backward): x and dh sequences
  read, dx and h sequences written (bf16), ten f32 state tensors, the
  weights read and their gradients written; three times the forward's
  operations (the recomputation is not work the algorithm needs);
- the voxelizer: 16 bytes a valid event read, the uint8 histogram
  written;
- NMS over the anchors of each frame: a byte a box read (its validity)
  and a byte written (kept), plus 16 bytes a candidate box.

Each part's least time is the larger of its operations at the dense bf16
peak and its bytes at the HBM bandwidth.
"""
from __future__ import annotations

from benchmark.counts.flops import PEAK_BF16_FLOPS, PEAK_BYTES


def _least(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_BF16_FLOPS)


def stages(A: dict):
    H, W = A["in_res_hw"]
    s, out = 1, []
    for i, m in enumerate(A["dim_multiplier"]):
        s *= A["stem_patch_size"] if i == 0 else 2
        out.append((H // s, W // s, A["embed_dim"] * m))
    return out


def anchors(A: dict) -> int:
    H, W = A["in_res_hw"]
    st = [A["stem_patch_size"] * 2 ** (i - 1) for i in A["fpn_in_stages"]]
    return sum((H // s) * (W // s) for s in st)


def _stage(A, H, W, C, T, B, train):
    n = A["partition_size"][0] * A["partition_size"][1]
    M, P = T * B * H * W, B * H * W
    wbytes = 2 * (2 * 12 * C * C + 8 * C * C)
    pair_ops = M * 2 * (24 * C * C + 4 * n * C)
    lstm_ops = M * 16 * C * C
    if train:
        return _least(M * C * 8 + 10 * P * C * 4 + 2 * wbytes,
                      3 * (pair_ops + lstm_ops))
    return _least(M * C * 4 + 4 * P * C * 4 + wbytes, pair_ops + lstm_ops)


def nms(A: dict, frames: int, candidates: int = 0) -> float:
    return _least(2 * frames * anchors(A) + 16 * candidates, 0)


def eval_window(A: dict, B: int, T: int, K: int) -> float:
    return (sum(_stage(A, H, W, C, T, B, False) for H, W, C in stages(A))
            + nms(A, B * K))


def train_step(A: dict, B: int, T: int) -> float:
    return sum(_stage(A, H, W, C, T, B, True) for H, W, C in stages(A))


def voxelizer(events: int, B: int, bins: int, H: int, W: int) -> float:
    return _least(16 * events + B * 2 * bins * H * W, 0)


def raw_call(A: dict, B: int, events: int, bins: int) -> float:
    H, W = A["resolution_hw"]
    return (sum(_stage(A, h, w, C, 1, B, False) for h, w, C in stages(A))
            + voxelizer(events, B, bins, H, W) + nms(A, B))

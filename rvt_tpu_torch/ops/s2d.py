"""Space-to-depth input blocking for the stem convolution (copy of
``rvt_tpu/ops/s2d.py``).

The 7x7 stride-4 stem over 20 channels is re-expressed as a 2x2 stride-1
conv over 4x4-space-to-depth-blocked input (contraction depth 16*C). The
blocking is a uint8 re-layout, on the host or on the card
(``device_space_to_depth``); the model folds its
stored 7x7 kernel into the equivalent 2x2 kernel (exact).

Derivation: output(i,j) = sum_{u,v} x[4i+u-3, 4j+v-3] w[u,v]. With block
index p = floor(r/4), offset a = r mod 4 (r = input row), the taps regroup
as w2[t, a] = w7[4t + a - 1] for t in {0, 1} (the single out-of-range tap
(t=0, a=0) is zero). Input is padded by one 4-block on top/left.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BLOCK = 4  # stem patch size


def host_space_to_depth(ev: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """[..., H, W, C] uint8 -> [..., H'/4 + 1, W'/4 + 1, 16*C] where H', W'
    = target_hw (corner-padded model resolution). Host-side numpy."""
    *lead, H, W, C = ev.shape
    th, tw = target_hw
    assert th % BLOCK == 0 and tw % BLOCK == 0
    pad = [(0, 0)] * len(lead) + [(BLOCK, th - H), (BLOCK, tw - W), (0, 0)]
    x = np.pad(ev, pad)
    Hp, Wp = (th + BLOCK) // BLOCK, (tw + BLOCK) // BLOCK
    x = x.reshape(*lead, Hp, BLOCK, Wp, BLOCK, C)
    x = np.moveaxis(x, -4, -3)  # [..., Hp, Wp, BLOCK, BLOCK, C]
    return np.ascontiguousarray(x.reshape(*lead, Hp, Wp, BLOCK * BLOCK * C))


def device_space_to_depth(ev: torch.Tensor,
                          target_hw: Tuple[int, int]) -> torch.Tensor:
    """``host_space_to_depth`` on the tensor's device (the torch twin of
    ``rvt_tpu/ops/s2d.py:device_space_to_depth``): the same pad, reshape
    and channel order; returns a contiguous tensor."""
    *lead, H, W, C = ev.shape
    th, tw = target_hw
    if th % BLOCK or tw % BLOCK:
        raise ValueError(f"target {target_hw} is not a multiple of {BLOCK}")
    x = torch.nn.functional.pad(ev, (0, 0, BLOCK, tw - W, BLOCK, th - H))
    Hp, Wp = (th + BLOCK) // BLOCK, (tw + BLOCK) // BLOCK
    x = x.reshape(*lead, Hp, BLOCK, Wp, BLOCK, C)
    x = x.movedim(-4, -3)  # [..., Hp, Wp, BLOCK, BLOCK, C]
    return x.reshape(*lead, Hp, Wp, BLOCK * BLOCK * C)


def host_depth_to_space(ev: np.ndarray, orig_hw: Tuple[int, int],
                        channels: int) -> np.ndarray:
    """Inverse of ``host_space_to_depth``: [..., Hp, Wp, 16*C] blocked
    tensor -> [..., H, W, C] at the original storage resolution (drops the
    one-block top/left pad and the corner pad). Used to recover renderable
    frames when the pipeline already emitted s2d-blocked input (train-time
    viz panels)."""
    *lead, Hp, Wp, CB = ev.shape
    C = channels
    assert CB == BLOCK * BLOCK * C, (CB, C)
    x = ev.reshape(*lead, Hp, Wp, BLOCK, BLOCK, C)
    x = np.moveaxis(x, -3, -4)  # [..., Hp, BLOCK, Wp, BLOCK, C]
    x = x.reshape(*lead, Hp * BLOCK, Wp * BLOCK, C)
    H, W = orig_hw
    return x[..., BLOCK:BLOCK + H, BLOCK:BLOCK + W, :]


def fold_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """[7, 7, C, D] (HWIO) stem kernel -> [2, 2, 16*C, D] blocked kernel.

    Channel order matches host_space_to_depth: (row-offset a, col-offset b,
    C). Pure reshape/permute of a zero-padded copy."""
    C, D = w7.shape[2], w7.shape[3]
    wp = torch.nn.functional.pad(w7, (0, 0, 0, 0, 1, 0, 1, 0))  # [8, 8, C, D]
    wk = wp.reshape(2, BLOCK, 2, BLOCK, C, D)  # [t, a, s, b, C, D]
    wk = wk.permute(0, 2, 1, 3, 4, 5)          # [t, s, a, b, C, D]
    return wk.reshape(2, 2, BLOCK * BLOCK * C, D)


def s2d_input_hw(target_hw: Tuple[int, int]) -> Tuple[int, int]:
    return (target_hw[0] + BLOCK) // BLOCK, (target_hw[1] + BLOCK) // BLOCK

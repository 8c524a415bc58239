"""Space-to-depth input blocking for the stem convolution (copy of
``rvt_tpu/ops/s2d.py``).

The 7x7 stride-4 stem over 20 channels is re-expressed as a 2x2 stride-1
conv over 4x4-space-to-depth-blocked input (contraction depth 16*C). The
blocking is a uint8 re-layout, on the host or on the card
(``device_space_to_depth``); the model folds its
stored 7x7 kernel into the equivalent 2x2 kernel (exact). The steps block
an unblocked window themselves (``window_s2d``): on a card the
hand-written kernel ``csrc/window_s2d.cu`` reads the stored window once
and writes the stem's bf16 operand, T-major, once.

Derivation: output(i,j) = sum_{u,v} x[4i+u-3, 4j+v-3] w[u,v]. With block
index p = floor(r/4), offset a = r mod 4 (r = input row), the taps regroup
as w2[t, a] = w7[4t + a - 1] for t in {0, 1} (the single out-of-range tap
(t=0, a=0) is zero). Input is padded by one 4-block on top/left.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.kernels import Counter, check, ptr, stream_ptr

BLOCK = 4  # stem patch size
WINDOW_S2D = Counter("window_s2d")
# the most shared memory a block of csrc/window_s2d.cu may take (the
# H100's 227 KB opt-in): its four staged input rows, 16 * Wp * C bytes; the
# C entry raises a block's limit to what a launch needs above 48 KB
_WINDOW_S2D_SMEM = 232448


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


def window_s2d_plain(ev: torch.Tensor,
                     target_hw: Tuple[int, int]) -> torch.Tensor:
    """``window_s2d``'s plain version: ``device_space_to_depth`` of each
    frame, T-major, cast to bf16 (exact for uint8), contiguous."""
    x = device_space_to_depth(ev, target_hw).transpose(0, 1).contiguous()
    return x.to(torch.bfloat16)


def window_s2d(ev: torch.Tensor, target_hw: Tuple[int, int], *,
               plain: bool = False) -> torch.Tensor:
    """A window [B, T, H, W, C] uint8, any strides, as the s2d stem takes
    it: [T, B, Hp, Wp, 16*C] bf16, contiguous, each frame
    ``device_space_to_depth``'s. On a CUDA tensor the kernel
    ``csrc/window_s2d.cu`` (one pass; the stored [B, T, C, H, W] buffer's
    channel-last view is its fast path), else the plain version."""
    B, T, H, W, C = ev.shape
    th, tw = target_hw
    # both routes take the same windows: the plain one is exact for uint8
    kernels.need(ev.dtype == torch.uint8 and th % BLOCK == 0
                 and tw % BLOCK == 0 and H <= th and W <= tw,
                 f"window_s2d: uint8 [B, T, H, W, C] within {target_hw}, "
                 f"a multiple of {BLOCK} (got {ev.dtype} "
                 f"{tuple(ev.shape)})")
    if plain or not ev.is_cuda:
        return window_s2d_plain(ev, target_hw)
    Hp, Wp = s2d_input_hw(target_hw)
    kernels.need(16 * Wp * C <= _WINDOW_S2D_SMEM,
                 f"window_s2d: {16 * Wp * C} bytes of staged rows a block, "
                 f"more than {_WINDOW_S2D_SMEM}")
    out = torch.empty((T, B, Hp, Wp, BLOCK * BLOCK * C),
                      dtype=torch.bfloat16, device=ev.device)
    err = kernels.lib("window_s2d").rvt_window_s2d(
        ptr(ev), ptr(out), B, T, H, W, C, *ev.stride(), Hp, Wp,
        stream_ptr(ev))
    check(err, "window_s2d")
    WINDOW_S2D.launches += 1
    return out


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

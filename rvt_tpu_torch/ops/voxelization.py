"""Event-stream voxelization: raw events -> stacked-histogram frames.

Port of the serving voxelizer of ``rvt_tpu/ops/voxelization.py``. The TPU
kernel (``stacked_histogram_pallas_batched`` / ``_hist_tile_kernel``)
sorts events by output tile and sums one-hot products on the matrix unit
because Mosaic cannot scatter. Hopper can: ``csrc/stacked_histogram.cu``
adds one per event with atomics into an int32 histogram and saturates it
to uint8 in a second pass.

The semantics are the Pallas kernel's, not the XLA scatter's: an event
counts when its index is below its lane's ``counts`` and 0 <= x < W,
0 <= y < H, p in {0, 1}; every other event is dropped. (The JAX package's
XLA ``stacked_histogram`` row-aliases an x that overflows into the next
row instead; the two agree on in-range events.)
"""
from __future__ import annotations

import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.kernels import (Counter, check, check_operands, need,
                                       ptr, stream_ptr)

STACKED_HISTOGRAM = Counter("stacked_histogram")


def _time_bin_indices(t: torch.Tensor, counts: torch.Tensor,
                      bins: int) -> torch.Tensor:
    """[B, N] time bins in [0, bins): floor of (t - t0) / max(t1 - t0, 1)
    * bins in f32, with t0 = t[:, 0] and t1 = t[:, max(counts, 1) - 1]
    (clamped into the array, as JAX's gather clamps). The same f32 steps
    as ``rvt_tpu/ops/voxelization.py:_time_bin_indices``; int32
    differences wrap as there."""
    last = (counts.clamp(min=1) - 1).clamp(max=t.shape[1] - 1).long()
    t0 = t[:, :1]
    t1 = torch.gather(t, 1, last[:, None])
    denom = torch.clamp(t1 - t0, min=1).float()
    t_norm = (t - t0).float() / denom
    # clip in f32, then convert: an out-of-range float never reaches int
    return torch.floor(t_norm * bins).clamp(0, bins - 1).to(torch.int32)


def flat_bins(x: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
              t: torch.Tensor, counts: torch.Tensor, bins: int, height: int,
              width: int) -> torch.Tensor:
    """Each event's index into the flattened [B, 2*bins, H, W] histogram,
    [B, N] int64; a dropped event gets B * 2*bins*H*W, one past the end."""
    B, N = x.shape
    plane = 2 * bins * height * width
    keep = ((torch.arange(N, device=x.device)[None, :] < counts[:, None])
            & (x >= 0) & (x < width) & (y >= 0) & (y < height)
            & (p >= 0) & (p <= 1))
    t_idx = _time_bin_indices(t, counts, bins)
    flat = ((p.long() * bins + t_idx) * height + y) * width + x
    flat = flat + torch.arange(B, device=x.device)[:, None] * plane
    return torch.where(keep, flat, B * plane)


def stacked_histogram_plain(x: torch.Tensor, y: torch.Tensor,
                            p: torch.Tensor, t: torch.Tensor,
                            counts: torch.Tensor, bins: int, height: int,
                            width: int, count_cutoff: int = 255
                            ) -> torch.Tensor:
    """The kernel's function in PyTorch ops: count each kept event's bin,
    saturate at ``count_cutoff``, narrow to uint8."""
    B = x.shape[0]
    plane = 2 * bins * height * width
    hist = torch.bincount(
        flat_bins(x, y, p, t, counts, bins, height, width).reshape(-1),
        minlength=B * plane + 1)[:B * plane]
    return hist.clamp(max=count_cutoff).to(torch.uint8).reshape(
        B, 2 * bins, height, width)


def stacked_histogram_batched(x: torch.Tensor, y: torch.Tensor,
                              p: torch.Tensor, t: torch.Tensor,
                              counts: torch.Tensor, bins: int, height: int,
                              width: int, count_cutoff: int = 255, *,
                              plain: bool = False) -> torch.Tensor:
    """Stacked histogram of a batch of event lanes (the layout of
    ``stacked_histogram_pallas_batched``): x, y, p, t [B, N] int32, t
    sorted in each lane, ``counts`` [B] int32 valid leading events (at
    most N). Returns [B, 2*bins, height, width] uint8."""
    if plain or not x.is_cuda:
        return stacked_histogram_plain(x, y, p, t, counts, bins, height,
                                       width, count_cutoff)
    B, N = x.shape
    counts = counts.contiguous()
    check_operands("stacked_histogram", x, y, p, t, counts)
    need(all(a.dtype == torch.int32 and tuple(a.shape) == (B, N)
             for a in (x, y, p, t))
         and counts.dtype == torch.int32 and tuple(counts.shape) == (B,)
         and bins >= 1 and 0 < count_cutoff <= 255,
         "stacked_histogram: x, y, p, t int32 [B, N], counts int32 [B], "
         "bins >= 1, 0 < count_cutoff <= 255")
    shape = (B, 2 * bins, height, width)
    scratch = torch.empty(shape, dtype=torch.int32, device=x.device)
    out = torch.empty(shape, dtype=torch.uint8, device=x.device)
    err = kernels.lib("stacked_histogram").rvt_stacked_histogram(
        ptr(x), ptr(y), ptr(p), ptr(t), ptr(counts), ptr(scratch), ptr(out),
        B, N, bins, height, width, count_cutoff, stream_ptr(x))
    check(err, "stacked_histogram")
    STACKED_HISTOGRAM.launches += 1
    return out

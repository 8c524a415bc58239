"""Event-stream voxelization: raw events -> stacked-histogram frames.

Port of the serving voxelizer of ``rvt_tpu/ops/voxelization.py``. The TPU
kernel (``stacked_histogram_pallas_batched`` / ``_hist_tile_kernel``)
sorts events by output tile and sums one-hot products for each tile on
the matrix unit. ``csrc/stacked_histogram.cu`` keeps the sort by tile:
each block of events sorts its events by output tile (16-bit in-tile
indices and a table of each tile's offset and count), then one block a
tile counts the entries the event blocks wrote for it in shared memory
and writes the tile's uint8 bins once (``histogram_plan``). The table
and the sorted indices are a per-device workspace kept from call to
call.

The semantics are the Pallas kernel's, not the XLA scatter's: an event
counts when its index is below its lane's ``counts`` and 0 <= x < W,
0 <= y < H, p in {0, 1}; every other event is dropped. (The JAX package's
XLA ``stacked_histogram`` row-aliases an x that overflows into the next
row instead; the two agree on in-range events.)

``repair_time_monotonicity`` and ``mixed_density_stack`` are JAX's
functions of the same names in eager PyTorch: its TPU kernel covers the
stacked histogram only, and these are XLA ops there.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.kernels import (Counter, check, check_operands, need,
                                       ptr, stream_ptr)

STACKED_HISTOGRAM = Counter("stacked_histogram")

# bins of one tile block (csrc/stacked_histogram.cu:kTileBins): 16-bit
# counters two a word, 48 KB of shared memory, four blocks an SM; a
# multiple of 16 below 2**16 (the 16-bit in-tile indices)
HIST_TILE_BINS = 24576
HIST_EVENTS_PER_BLOCK = 1024  # the bucket kernel's block of events
HIST_MAX_SPAN = 5632          # csrc/stacked_histogram.cu:kMaxSpan


class HistPlan(NamedTuple):
    """How ``csrc/stacked_histogram.cu`` cuts one call's work."""
    total: int         # output bins, B * 2*bins*H*W
    tile_bins: int     # bins of one tile, counted by one block
    tiles: int         # tile blocks; tile k holds bins [k, k+1) * tile_bins
    span: int          # the most tiles one lane's plane touches
    event_blocks: int  # bucket blocks a lane
    launches: int      # kernel launches a call: bucket, tile

    @property
    def table_entries(self) -> int:
        """(offset, count) pairs of the bucket kernel's table, per lane."""
        return self.event_blocks * self.span

    @property
    def chunk_entries(self) -> int:
        """16-bit in-tile indices of the chunk array, per lane."""
        return self.event_blocks * HIST_EVENTS_PER_BLOCK


@functools.lru_cache(maxsize=64)
def histogram_plan(B: int, N: int, bins: int, height: int,
                   width: int) -> HistPlan:
    """The tiles of the flat [B * 2*bins*H*W] output (the last one
    ragged; a tile may span lanes) and the blocks of one call."""
    plane = 2 * bins * height * width
    total = B * plane
    tiles = max(1, -(-total // HIST_TILE_BINS))
    span = min(tiles, -(-plane // HIST_TILE_BINS) + 1)
    if span > HIST_MAX_SPAN:
        raise ValueError(f"stacked_histogram: a lane of {plane} bins spans "
                         f"more than {HIST_MAX_SPAN} tiles")
    return HistPlan(total, HIST_TILE_BINS, tiles, span,
                    max(1, -(-N // HIST_EVENTS_PER_BLOCK)), 2)


_HIST_WS: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def _hist_workspace(like: torch.Tensor, table: int, chunk: int):
    """The device's voxelizer workspace: the bucket kernel's (offset,
    count) table, int32 [2 * table], and its chunk array of 16-bit in-tile
    indices, [chunk]; grown when a call needs more, the old one retired
    (``kernels.retire``: a captured graph may still write it). Every entry
    a call reads, it wrote first: nothing to reset. The port launches on
    one stream, and every captured step replays on it, so one call's chunk
    is read before the next call writes it."""
    dev = like.get_device()
    ws = _HIST_WS.get(dev)
    if ws is None or ws[0].numel() < 2 * table or ws[1].numel() < chunk:
        old_t, old_c = (ws[0].numel(), ws[1].numel()) if ws else (0, 0)
        if ws is not None:
            kernels.retire(*ws)
        ws = _HIST_WS[dev] = (
            torch.empty(max(2 * table, old_t, 1 << 14), dtype=torch.int32,
                        device=like.device),
            torch.empty(max(chunk, old_c, 1 << 18), dtype=torch.int16,
                        device=like.device))
    return ws


def _time_bin_indices(t: torch.Tensor, counts: torch.Tensor,
                      bins: int) -> torch.Tensor:
    """[B, N] time bins in [0, bins): floor of (t - t0) / max(t1 - t0, 1)
    * bins in f32, with t0 = t[:, 0] and t1 = t[:, max(counts, 1) - 1]
    (clamped into the array, as JAX's gather clamps). The same f32 steps
    as ``rvt_tpu/ops/voxelization.py:_time_bin_indices``; int32
    differences wrap as there."""
    if t.shape[1] == 0:
        return torch.zeros_like(t)
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
    ``stacked_histogram_pallas_batched``): x, y, p, t [B, N] int32 (t in
    any order: each lane's time bins span t[b, 0] to t[b, counts - 1]),
    ``counts`` [B] int32 valid leading events (more than N counts as N).
    Returns [B, 2*bins, height, width] uint8."""
    if plain or not x.is_cuda:
        return stacked_histogram_plain(x, y, p, t, counts, bins, height,
                                       width, count_cutoff)
    B, N = x.shape
    counts = counts.contiguous()
    check_operands("stacked_histogram", x, y, p, t, counts)
    need(all(a.dtype == torch.int32 and tuple(a.shape) == (B, N)
             for a in (x, y, p, t))
         and counts.dtype == torch.int32 and tuple(counts.shape) == (B,)
         and bins >= 1 and height >= 1 and width >= 1 and B >= 1
         and B * N < 2 ** 31 and 0 < count_cutoff <= 255
         and 2 * bins * height * width + HIST_TILE_BINS < 2 ** 31,
         "stacked_histogram: x, y, p, t int32 [B, N], counts int32 [B], "
         "B >= 1, bins, height, width >= 1, B * N < 2**31, a lane's "
         "2*bins*H*W bins in 31 bits, 0 < count_cutoff <= 255")
    plan = histogram_plan(B, N, bins, height, width)
    table, chunk = _hist_workspace(x, B * plan.table_entries,
                                   B * plan.chunk_entries)
    out = torch.empty((B, 2 * bins, height, width), dtype=torch.uint8,
                      device=x.device)
    err = kernels.lib("stacked_histogram").rvt_stacked_histogram(
        ptr(x), ptr(y), ptr(p), ptr(t), ptr(counts), ptr(table), ptr(chunk),
        ptr(out), B, N, bins, height, width, count_cutoff, plan.tile_bins,
        plan.tiles, plan.span, plan.event_blocks, stream_ptr(x))
    check(err, "stacked_histogram")
    STACKED_HISTOGRAM.launches += 1
    return out


def repair_time_monotonicity(t: torch.Tensor) -> torch.Tensor:
    """Running max over event timestamps along the first axis (the numba
    loop at the upstream ``preprocess_dataset.py:163-172``; JAX's
    ``associative_scan`` of ``maximum``)."""
    return torch.cummax(t, dim=0).values


def mixed_density_stack(x: torch.Tensor, y: torch.Tensor, pol: torch.Tensor,
                        t: torch.Tensor, num_events, bins: int, height: int,
                        width: int, count_cutoff: int = 127) -> torch.Tensor:
    """MixedDensityEventStack (upstream ``representations.py:130-218``) on
    padded events: x, y, pol, t [N] int (sorted by t), ``num_events``
    valid leading events. Log2-spaced time bins, polarity +/-1 summed in
    int32, a cumulative sum over bins, clipped to +/-count_cutoff.
    Returns [bins, H, W] int8.

    The same f32 steps in the same order as
    ``rvt_tpu/ops/voxelization.py:mixed_density_stack``: t_norm's
    division, the clip, the log over a 0-d f32 tensor (a Python float
    divisor lets CUDA multiply by its reciprocal instead), so an event on
    a bin edge lands in the same bin. An index past either end drops its
    event after a negative one wraps once, as JAX's ``mode="drop"``
    scatter does."""
    N = x.shape[0]
    dev = x.device
    if N == 0:
        return torch.zeros((bins, height, width), dtype=torch.int8,
                           device=dev)
    num_events = torch.as_tensor(num_events, device=dev)
    valid = torch.arange(N, device=dev) < num_events
    total = bins * height * width
    t0 = t[0]
    t1 = t[num_events.clamp(min=1) - 1]
    denom = torch.clamp(t1 - t0, min=1).float()
    t_norm = torch.clamp((t - t0).float() / denom, 1e-6, 1 - 1e-6)
    log_half = torch.tensor(math.log(0.5), dtype=torch.float32, device=dev)
    bin_float = torch.clamp(bins - torch.log(t_norm) / log_half, min=0.0)
    t_idx = torch.clamp(torch.floor(bin_float).to(torch.int32),
                        max=bins - 1)
    flat = x.long() + width * y.long() + height * width * t_idx.long()
    flat = torch.where(valid, flat, total)
    flat = torch.where(flat < 0, flat + total, flat)
    keep = (flat >= 0) & (flat < total)
    values = torch.where(valid & keep, pol.int() * 2 - 1, 0).to(torch.int32)
    rep = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    rep.index_add_(0, torch.where(keep, flat, total), values)
    rep = torch.cumsum(rep[:total].reshape(bins, height, width), dim=0,
                       dtype=torch.int32)
    return torch.clamp(rep, -count_cutoff, count_cutoff).to(torch.int8)

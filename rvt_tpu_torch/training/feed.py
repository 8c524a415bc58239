"""The host-to-card feed of the validation loop and the Trainer.

A window leaves ``data/streaming.py:_stack`` as a channel-last view
[B, T, H, W, C] of the stacked [B, T, C, H, W] uint8 buffer. The feed
copies that buffer as it is stored (``stored_layout``: a view, no host
copy) into one of two pinned staging slots, copies it to the card on a
side stream that the compute stream waits for, and hands the steps its
channel-last view (``window_input``): for an s2d stem as it is, since the
steps block and cast it in one pass (``training/step.py:window_seq``),
else as a contiguous copy. A slot is refilled only after the event of
its last copy, so the host may stack the next window while the card
copies this one. On the CPU the arrays become tensors without a copy.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from rvt_tpu_torch.utils import timers


def stored_layout(ev: np.ndarray) -> Tuple[np.ndarray, bool]:
    """The [B, T, C, H, W] array behind a channel-last window view and
    True, or the window itself and False where it is not such a view."""
    stored = ev.transpose(0, 1, 4, 2, 3)
    if stored.flags.c_contiguous:
        return stored, True
    return ev, False


def window_input(x: torch.Tensor, stored: bool, in_res_hw: Tuple[int, int],
                 stem_s2d: bool) -> torch.Tensor:
    """A fed window as the steps take it: channel-last [B, T, H, W, C]
    within ``in_res_hw``; for an s2d stem the view of the stored buffer
    (no device work), else contiguous (the span ``feed.window_input``)."""
    with timers.span("feed.window_input", x.device):
        if stored:
            x = x.permute(0, 1, 3, 4, 2)
        if x.shape[2] > in_res_hw[0] or x.shape[3] > in_res_hw[1]:
            raise ValueError(f"window {tuple(x.shape)} exceeds {in_res_hw}")
        return x if stem_s2d else x.contiguous()


class PinnedFeed:
    """Copies lists of host arrays to ``device`` through two pinned
    staging slots, in turn (the event-guarded H2D above); on the CPU,
    tensors over the arrays."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._slots = [[None, None], [None, None]]  # (buffers, last copy)
        self._next = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        host = [torch.from_numpy(np.asarray(a)) for a in arrays]
        if self._stream is None:
            return [h.to(self.device) for h in host]
        slot = self._slots[self._next]
        self._next = 1 - self._next
        bufs, done = slot
        if done is not None:
            done.synchronize()  # the slot's last copy has left it
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != [
                (h.shape, h.dtype) for h in host]:
            bufs = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                    for h in host]
        for b, h in zip(bufs, host):
            b.copy_(h)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            outs = [b.to(self.device, non_blocking=True) for b in bufs]
            done = torch.cuda.Event()
            done.record(self._stream)
        slot[0], slot[1] = bufs, done
        compute.wait_event(done)
        for o in outs:  # made on the copy stream, read on the compute one
            o.record_stream(compute)
        return outs

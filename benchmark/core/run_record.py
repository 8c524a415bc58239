"""What a run hands the metric readers (``readers/<reader>.py``)."""
from __future__ import annotations

from dataclasses import dataclass

from benchmark.core.loop import Window


@dataclass
class Run:
    cell: str
    driver: object          # the traffic driver: frames, FLOPs, bounds
    window: Window
    setup_s: float
    window_peak_bytes: int  # the allocator's reserved peak over the window

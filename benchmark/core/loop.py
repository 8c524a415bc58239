"""The measured window: calls back to back for a fixed time, and in a
traced run a profiled sub-window of a fixed number of calls inside it.

A driver gives ``call(i)``, which launches call i and waits for whatever
its user waits for (an earlier window's detections, this call's), and
``finish()``, which waits for the rest. The window is the host clock from
the first call to ``finish``'s return: every call launched in it has
completed there. In a traced run the profiler records the workload's
``profile.calls`` calls from ``profile.after_s`` into the window, between
two device synchronisations; the calls outside it give the traced run's own
rate (``outside``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from benchmark.core import trace as trace_mod
from benchmark.core.trace import sync


@dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    outside_calls: int = 0        # traced run: calls outside the profile
    outside_seconds: float = 0.0
    profile: Optional[trace_mod.Profile] = None


def timed_window(call: Callable[[int], None], finish: Callable[[], None],
                 seconds: float, device, profile: Optional[dict] = None
                 ) -> Window:
    """Run the window. ``profile``: {"after_s", "calls"} or None."""
    w = Window()
    sync(device)
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    prof_at = None if profile is None else t0 + profile["after_s"]
    while time.perf_counter() < end:
        if prof_at is not None and time.perf_counter() >= prof_at:
            prof_at = None
            sync(device)
            t_in = time.perf_counter()
            w.profile = trace_mod.profile_calls(
                lambda j: call(i + j), profile["calls"], device)
            # the profiled calls' own wait is done: the device is idle
            i += profile["calls"]
            w.outside_seconds -= time.perf_counter() - t_in
            continue
        call(i)
        i += 1
    finish()
    sync(device)
    w.seconds = time.perf_counter() - t0
    w.calls = i
    if w.profile is not None:
        w.outside_seconds += w.seconds
        w.outside_calls = i - w.profile.calls
    return w

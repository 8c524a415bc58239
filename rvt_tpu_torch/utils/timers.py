"""Region timers and profiling hooks: the port's counterpart of
``rvt_tpu/utils/timers.py`` (upstream ``utils/timers.py:12-95``:
CudaTimer / Timer / TimerDummy with an atexit summary).

``DeviceTimer`` ends its region when the device work it observes is
done: it records CUDA events around the region on the current stream
and waits for the end event (the reference's cuda-synchronize timer,
JAX's ``block_until_ready`` on the observed arrays); on the CPU it
times the wall clock. ``profile_trace`` wraps ``torch.profiler`` and
writes a Chrome trace. As in the reference, the dummy timer is what hot
paths take by default; import ``DeviceTimer`` / ``Timer`` to time.
"""
from __future__ import annotations

import atexit
import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch
from torch.utils import _pytree as pytree

_TIMING_SUMS: Dict[str, float] = defaultdict(float)
_TIMING_COUNTS: Dict[str, int] = defaultdict(int)


def _record(name: str, seconds: float) -> None:
    _TIMING_SUMS[name] += seconds
    _TIMING_COUNTS[name] += 1


class Timer:
    """Wall-clock region timer accumulating into a global summary."""

    def __init__(self, timer_name: str = ""):
        self.name = timer_name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _record(self.name, time.perf_counter() - self._t0)


class DeviceTimer(Timer):
    """Times a region until the device work it launched is done. With
    ``observe`` (tensors, or a tree of them), the region ends when the
    work on the current stream of the card they lie on has completed: a
    pair of CUDA events, the end one waited for. Without a CUDA tensor
    to observe, the wall clock."""

    def __init__(self, timer_name: str = "", observe=None):
        super().__init__(timer_name)
        self._observe = observe
        self._events = None

    def _device(self):
        for x in pytree.tree_leaves(self._observe):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                return x.device
        return None

    def __enter__(self):
        dev = self._device()
        if dev is not None:
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(dev))
        return super().__enter__()

    def __exit__(self, *exc):
        if self._events is None:
            return super().__exit__(*exc)
        start, end = self._events
        end.record(torch.cuda.current_stream(self._device()))
        end.synchronize()
        _record(self.name, start.elapsed_time(end) / 1e3)


class TimerDummy:
    """No-op stand-in (the default in hot paths, as in the reference)."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed region (host and, on a card, device
    activity) with ``torch.profiler`` and write a Chrome trace into
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


def timing_summary() -> Dict[str, Dict[str, float]]:
    return {k: {"total_s": _TIMING_SUMS[k], "count": _TIMING_COUNTS[k],
                "mean_s": _TIMING_SUMS[k] / max(_TIMING_COUNTS[k], 1)}
            for k in _TIMING_SUMS}


@atexit.register
def _print_summary() -> None:  # pragma: no cover
    if not _TIMING_SUMS:
        return
    print("== Timing statistics ==")
    for name, s in timing_summary().items():
        print(f"  {name or '<unnamed>'}: total {s['total_s']:.3f}s over "
              f"{s['count']} calls (mean {s['mean_s'] * 1e3:.2f} ms)")

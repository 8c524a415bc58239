"""A profiled sub-window, read from the profiler's trace.

``torch.profiler`` records the device's kernels, copies and sets (CUPTI,
kernels inside CUDA graphs included) and the host's operators, runtime
calls and the harness's own spans (``bench.*``). The trace is exported to
a temporary file and read back: device busy time is the union of the
device intervals inside the sub-window, so kernels overlapping on two
streams count once; an idle gap is named by the innermost host event
that covers its middle (what the host was doing while the device
waited).

The program's hand-written kernels (``csrc/*.cu``) are told from the
library's by their names: each sits at the top of an anonymous namespace,
``(anonymous namespace)::<kernel>``, which no PyTorch, cuBLAS or cuDNN
kernel does.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

HAND_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::(\w+)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


@dataclass
class Profile:
    calls: int
    window_s: float                 # the sub-window's span in the trace
    busy_s: float                   # union of device intervals in it
    hand_s: float                   # hand-written kernels' device time
    other_kernel_s: float           # every other kernel's device time
    by_name: Dict[str, float] = field(default_factory=dict)
    hand_names: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def is_hand_kernel(name: str) -> bool:
    return HAND_KERNEL.match(name) is not None


def short_name(name: str) -> str:
    m = HAND_KERNEL.match(name)
    if m:
        return m.group(2)
    return name[:96]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile_calls(call: Callable[[int], None], n: int, device) -> Profile:
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.subwindow"):
            t0 = time.perf_counter()
            for j in range(n):
                call(j)
            sync(device)
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_trace(events, n, wall)


def read_trace(events: list, calls: int, wall: float) -> Profile:
    spans = [e for e in events if e.get("ph") == "X"]
    sub = [e for e in spans if e.get("name") == "bench.subwindow"
           and e.get("cat") in HOST_CATS]
    lo = min(e["ts"] for e in sub) if sub else None
    hi = max(e["ts"] + e["dur"] for e in sub) if sub else None
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if lo is None:
        lo = min(e["ts"] for e in dev)
        hi = max(e["ts"] + e["dur"] for e in dev)
    by_name: Dict[str, float] = defaultdict(float)
    hand: Dict[str, float] = defaultdict(float)
    hand_us = other_us = 0.0
    iv = []
    for e in dev:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        iv.append((a, b))
        if e["cat"] != "kernel":
            by_name["[" + e["cat"] + "] " + e["name"][:60]] += e["dur"]
            continue
        by_name[short_name(e["name"])] += e["dur"]
        if is_hand_kernel(e["name"]):
            hand[short_name(e["name"])] += e["dur"]
            hand_us += e["dur"]
        else:
            other_us += e["dur"]
    iv.sort()
    busy, gaps, cur_a, cur_b = 0.0, [], None, None
    edge = lo
    for a, b in iv:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > edge:
                gaps.append((edge, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        edge = max(edge, cur_b)
    if cur_b is not None:
        busy += cur_b - cur_a
        if hi > cur_b:
            gaps.append((cur_b, hi))
    host = [e for e in spans if e.get("cat") in HOST_CATS
            and e.get("name") != "bench.subwindow"]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(host_at(host, (a + b) / 2), (b - a) * 1e-6)
             for a, b in gaps[:10]]
    window_us = hi - lo
    return Profile(calls=calls,
                   window_s=window_us * 1e-6 if window_us > 0 else wall,
                   busy_s=busy * 1e-6,
                   hand_s=hand_us * 1e-6, other_kernel_s=other_us * 1e-6,
                   by_name={k: v * 1e-6 for k, v in by_name.items()},
                   hand_names={k: v * 1e-6 for k, v in hand.items()},
                   idle_gaps=named)


def host_at(host: list, t: float) -> str:
    """The innermost host event covering time ``t``."""
    best = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"]:
            if best is None or e["dur"] < best["dur"]:
                best = e
    return "host idle" if best is None else best["name"][:96]

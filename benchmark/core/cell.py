"""One run of one cell: set-up, the window, the readers, the check, and
the result line.

The order: the traffic driver's set-up (counted in ``setup_s`` from the
process's start), the window, the allocator's peak read, the readers,
the program's state freed, then the reference (counted nowhere) and
``correct``. ``run.py`` then looks for JAX among the loaded modules
before it prints the result.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Optional

import torch

from benchmark.core.loop import sync, timed_window
from benchmark.core.manifest import Manifest
from benchmark.core.run_record import Run

FORBIDDEN = ("jax", "jaxlib", "flax", "rvt_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name (before the
    first dot) is JAX's, flax's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number missing, not finite or without a limit fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if (limit is None or value is None or not math.isfinite(value)
                or value > limit):
            ok = False
    return ok, checks


def device_info(device, chips: int, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def breakdown(profile) -> dict:
    ops = sorted(profile.by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in profile.idle_gaps[:10]]}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda",
             manifest: Optional[Manifest] = None, log=None) -> dict:
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    m = manifest or Manifest()
    wl = m.workload(cell)
    cfg = m.config(wl["config"])
    driver = m.traffic(wl["traffic"]).Driver(cfg, wl, seed, device)
    cuda = torch.device(device).type == "cuda"
    driver.setup(seconds)
    sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_reserved() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    log(f"{cell}: set-up {setup_s:.3f} s, seed {seed}")
    window = timed_window(driver.call, driver.finish, seconds, device,
                          wl["profile"] if trace else None)
    window_peak = torch.cuda.max_memory_reserved() if cuda else 0
    run = Run(cell, driver, window, setup_s, window_peak)
    metrics = {}
    for spec in m.metrics_of(cell, trace):
        value = m.reader(spec["name"])(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    log(f"{cell}: {window.calls} calls in {window.seconds:.3f} s")
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings, _ = driver.check()
    for name, value in readings.items():
        if name not in wl["limits"]:
            log(f"reading {name} {value!r} (not compared)")
    correct, checks = judge(readings, wl["limits"])
    correct = correct and driver.failed == 0 and driver.attempted > 0
    result = {"correct": correct, "attempted": driver.attempted,
              "failed": driver.failed, "metrics": metrics,
              "device": device_info(device, wl["chips"],
                                    max(setup_peak, window_peak))}
    if trace and window.profile is not None:
        result["device"]["busy_s"] = window.profile.busy_s
        result["device"]["window_s"] = window.profile.window_s
        result["breakdown"] = breakdown(window.profile)
    result["checks"] = checks
    return result

#!/usr/bin/env python3
"""Readings for the limits of a cell's check, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--extra half_batch,bf16] [--seconds 2]

For each seed: the cell's set-up, a short window at the cell's load, the
program's state freed, then the numbers the check compares, as the
program gives them; for each of ``--control-seeds`` also the control's
(the reference computed with float8 operands, in the program's place, on
the same inputs) and, for a training cell, each reading of ``--extra``
(a fault planted in the reference in the program's place, or the
reference in bfloat16). One JSON line a seed,
then a summary: the largest program reading and the smallest control or
fault reading of each number. The limits in ``workloads/<cell>.json``
are set from these, as ``PERF.md`` records.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--extra", default="",
                    help="training: half_batch,bf16 (see tbptt_train.check)")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.core.loop import timed_window
    from benchmark.core.manifest import Manifest

    m = Manifest()
    wl = m.workload(args.workload)
    cfg = m.config(wl["config"])
    traffic = m.traffic(wl["traffic"])
    extra = [f for f in args.extra.split(",") if f]
    prog, ctrl = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        d = traffic.Driver(cfg, wl, seed, "cuda")
        d.setup(args.seconds)
        w = timed_window(d.call, d.finish, args.seconds, "cuda")
        d.release()
        gc.collect()
        torch.cuda.empty_cache()
        control = seed in args.control_seeds
        kw = {"extra": extra} if extra and control else {}
        readings, creadings = d.check(control=control, **kw)
        line = {"seed": seed, "calls": w.calls, "failed": d.failed,
                "program": readings, "look": getattr(d, "look", None),
                "control": creadings,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if seed in args.seeds:
            for k, v in readings.items():
                prog.setdefault(k, []).append(v)
        for k, v in (creadings or {}).items():
            ctrl.setdefault(k, []).append(v)
        del d
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"program_max": {k: max(v) for k, v in prog.items()},
               "control_min": {k: min(v) for k, v in ctrl.items()}}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

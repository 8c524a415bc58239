#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``rvt_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The cell
(``BENCHMARK.json``'s ``workloads``) names its configuration
(``benchmark/configs/``), its traffic kind (``benchmark/traffic/``) and
its parameters (``benchmark/workloads/``). The run makes its inputs and
weights from the seed, warms up, measures for ``--seconds``, checks what
the timed path produced against the plain reference
(``benchmark/reference/``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read by
``benchmark/readers/``), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared beside its limit (also the
last lines of standard error).

It exits 2 without enough CUDA devices, and 3 if JAX or the JAX package
was loaded; then it prints no result. The kernels it builds go to the
checkout's ``build/kernels/``.
"""
import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, one host thread for PyTorch's CPU work: its pool's threads
# would contend with the thread that launches the card's work
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)

    from benchmark.core.cell import forbidden_modules, run_cell
    from benchmark.core.manifest import Manifest

    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START, manifest=manifest)
    found = forbidden_modules()
    if found:
        print(f"loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The step's share of the H100's dense bf16 peak (989 TFLOP/s): the
frozen FLOP count of a call (``counts/flops.py``) times the calls outside
the profiled sub-window, over their host-clock time."""
from benchmark.counts.flops import PEAK_BF16_FLOPS


def read(run):
    w = run.window
    if w.outside_calls <= 0 or w.outside_seconds <= 0:
        return None
    return (100.0 * run.driver.flops_per_call * w.outside_calls
            / w.outside_seconds / PEAK_BF16_FLOPS)

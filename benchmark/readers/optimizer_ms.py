"""The optimizer layer's device time a train step: the clip, AdamW and
the gradient's norm (and the data-parallel reduce where there is one),
from the program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("optimizer")

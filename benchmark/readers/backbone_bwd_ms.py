"""The rest of the backward a train step: the gather's and the
backbone's (the device time of the ``backbone_bwd`` layer), from the
program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("backbone_bwd")

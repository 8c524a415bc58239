"""The backbone layer's device time a call (``scan_backbone`` or the raw
step's forward up to the neck: the stage kernels and the downsample
convolutions), from the program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("backbone")

"""The loss layer's device time a train step: the targets, SimOTA and
the YOLOX loss, from the program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("loss")

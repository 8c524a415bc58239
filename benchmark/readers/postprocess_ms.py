"""The postprocess layer's device time a call: the sigmoid, the
confidence filter, the top-k sort, ``nms_keep`` and the final gather,
from the program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("postprocess")

"""The detect layer's device time a call: the gather of the labelled
frames, PAFPN and the YOLOX head, from the program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("detect")

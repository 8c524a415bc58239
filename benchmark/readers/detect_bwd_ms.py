"""The backward of the loss, the head and PAFPN a train step, until the
gradient has reached the gathered backbone features (the device time of
the ``detect_bwd`` layer), from the program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("detect_bwd")

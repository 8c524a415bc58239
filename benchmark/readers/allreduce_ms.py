"""The data-parallel gradient all-reduce and the loss parts' sum a train
step (the step's ``allreduce`` layer, ranks above one only), from the
program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("allreduce")

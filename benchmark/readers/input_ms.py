"""The input layer a call: the step's own (the state reset, the padding,
the permute; the voxelizer on the raw path; the token mask and zero-grad
in training), the copy into the captured graph's static inputs
(``step.copy_in``) and, where the call has one, the feed's layout of the
window on the card (``feed.window_input``): their device time, from the
program's tracing."""
from benchmark.readers._program import device_ms


def read(run):
    return device_ms("input", "step.copy_in", "feed.window_input")

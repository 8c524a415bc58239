"""The boxes that enter NMS a frame: the valid candidates ``nms_keep``
counted (``nms_candidates``), over the frames it saw, from the
program's tracing."""
from benchmark.readers._program import counter


def read(run):
    return counter("nms_candidates", per_item=True)

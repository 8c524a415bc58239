"""The (gt, anchor) pairs SimOTA costs a train step, over the gathered
frames (``simota_pairs``, counted by ``ops/simota.py``; a rank's own
frames in data parallelism), from the program's tracing."""
from benchmark.readers._program import counter


def read(run):
    return counter("simota_pairs", per_item=False)

"""The hand-written kernels' launches a call (``ops/kernels.py:COUNTERS``,
which a replay credits with its capture's launches), from the program's
``launches`` counter."""
from benchmark.readers._program import counter


def read(run):
    return counter("launches", per_item=False)

"""Training frames completed per second over the whole window: B lanes x
T frames a step, as ``eval_frames_per_s`` counts a window's."""
from benchmark.readers.eval_frames_per_s import read  # noqa: F401

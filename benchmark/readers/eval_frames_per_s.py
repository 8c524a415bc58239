"""Event frames completed per second over the whole window: every call's
frames (B lanes x T frames a window or step), the window's host clock
from the first call to the last call's completion."""


def read(run):
    w = run.window
    return w.calls * run.driver.frames_per_call / w.seconds

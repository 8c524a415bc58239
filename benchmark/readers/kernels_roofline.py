"""The hand-written kernels' share of their roofline: the least time of
the work they do (``counts/bounds.py``, a call's worth times the calls
profiled) over their device time in the profile."""


def read(run):
    p = run.window.profile
    if p is None or p.hand_s <= 0:
        return None
    return 100.0 * run.driver.bound_per_call() * p.calls / p.hand_s

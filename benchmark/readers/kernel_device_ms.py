"""The hand-written kernels' device time a call (window, step or raw
call), from the profile."""


def read(run):
    p = run.window.profile
    if p is None or p.hand_s <= 0:
        return None
    return 1e3 * p.hand_s / p.calls

"""The memory the process holds on the card over the window, in GiB: the
caching allocator's reserved peak, reset after set-up. Reserved, not
allocated: a captured step's activations live in its graph's pool, which
the allocator counts as reserved and, between replays, not as
allocated."""


def read(run):
    return run.window_peak_bytes / 2 ** 30

"""What the program's own tracing (``rvt_tpu_torch/utils/timers.py``)
recorded: the profiler of a ``--trace 1`` run turns it on, so its summary
holds the profiled calls and nothing else. A value is per call of the
step (the ``step`` spans: a window, a train step or a raw call). A
program without that tracing (no ``timers.summary``, as in a checkout
from before it) gives None: the readers run over such a checkout when
it is compared with a later one."""


def summary():
    """The program's ``timers.summary()``, or None."""
    from rvt_tpu_torch.utils import timers

    fn = getattr(timers, "summary", None)
    return None if fn is None else fn()


def calls(s) -> int:
    return s["spans"].get("step", {}).get("count", 0)


def device_ms(first, *more):
    """The device time a call of span ``first`` (a layer), plus that of
    each of ``more`` the program recorded; None without ``first``'s."""
    s = summary()
    if s is None or not calls(s):
        return None
    spans = s["spans"]
    if spans.get(first, {}).get("device_count", 0) == 0:
        return None
    total = sum(spans[n]["device_s"] for n in (first,) + more
                if spans.get(n, {}).get("device_count", 0))
    return 1e3 * total / calls(s)


def counter(name, per_item: bool):
    """Counter ``name``'s sum a call, or with ``per_item`` its sum over
    the items it counted (frames)."""
    s = summary()
    c = (s or {}).get("counters", {}).get(name)
    if s is None or c is None or not calls(s):
        return None
    if per_item:
        return c["sum"] / c["items"] if c["items"] else None
    return c["sum"] / calls(s)

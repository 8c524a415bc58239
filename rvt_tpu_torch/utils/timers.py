"""The port's tracing: host spans, layer markers inside the steps (and
inside their captured CUDA graphs), and counters, kept in memory.

Tracing is on while a ``torch.profiler`` records and after
``enable(True)``. Then:

- ``span(name, device)`` times a host region (``perf_counter_ns``) and,
  given a card, the device work it launches, by a pair of timing events
  that are read later, when they are done: the span never waits for the
  card. It also opens a profiler ``record_function`` of the same name, so
  that it lies on the profiler's clock beside the device trace.
- ``mark(name)`` ends the step's current layer and starts ``name``.
  ``training/graphs.py:CapturedStep`` gives the step's body a collector
  of marks: during a capture always (``Captured``), as kernel nodes of
  the graph that write the card's clock into a ring of rows the graph
  owns, one row a replay (``csrc/trace_stamp.cu``), so that a replay runs
  none of the body's Python, pays a mark only its node, and is read in a
  batch, when the ring comes round or by ``summary()``, with no wait; on
  an eager step on a card, timing events; on the CPU, the host clock.
  The intervals between consecutive marks (the last one the step's end)
  are the layers.
- ``count(name, value)`` adds a counter to the step's collector: a
  number, or a tensor whose elements are summed when the step's marks
  are read (a captured step's tensor is copied into its graph's ring).

When tracing is off a span is one shared no-op context (one flag check,
no event, no record), and a mark or a count outside a collector does
nothing. Each record holds its name, its parent span's name, the call id
of the step call it belongs to (one process-wide sequence, advanced by
each step call: a record made between step calls carries the last one),
its host start and end, and where it has one, a device duration. The
last ``MAX_RECORDS`` records are kept; ``summary()`` collects what is
pending and sums them by name.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_RECORDS = 1 << 16
RING = 64        # rows of a captured step's ring: replays read late
MAX_MARKS = 16   # marks a captured step's body makes, its end included
MAX_KEPT = 4096  # counter elements a captured step's replay keeps

_ON = [False]
_CALL = [0]
_RECORDS: deque = deque(maxlen=MAX_RECORDS)
_PENDING: List["_Pending"] = []
_COLLECTOR: List[Optional["Layers"]] = [None]
_RINGS: Dict[int, "Captured"] = {}  # captured steps with replays unread
_EVENTS: List[torch.cuda.Event] = []  # timing events free for reuse
_SIDE: Dict[int, torch.cuda.Stream] = {}
_OPEN = threading.local()  # each thread's open spans
_IDS = itertools.count(1)


def enable(flag: bool = True) -> None:
    """Turn tracing on or off for the process (a running profiler turns
    it on as well)."""
    _ON[0] = bool(flag)


def on() -> bool:
    return _ON[0] or _profiler._is_profiler_enabled


def next_call() -> int:
    """Advance the call id: each step call does, before its spans."""
    _CALL[0] += 1
    return _CALL[0]


class Record:
    """A span (``value`` None) or a counter: ``value`` summed over
    ``items``."""
    __slots__ = ("name", "parent", "call", "t0", "t1", "device_s", "value",
                 "items", "rid", "pid")

    def __init__(self, name, parent=None, call=0, *, pid=None, t0=None,
                 t1=None, device_s=None, value=None, items=None):
        self.name, self.parent, self.call, self.pid = name, parent, call, pid
        self.t0, self.t1, self.device_s = t0, t1, device_s
        self.value, self.items = value, items
        self.rid = next(_IDS)


def _open() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _new(name: str, **kw) -> Record:
    """A record under the innermost open span of this thread."""
    stack = _open()
    parent = stack[-1].rec if stack else None
    rec = Record(name, parent and parent.name, _CALL[0],
                 pid=parent and parent.rid, **kw)
    _RECORDS.append(rec)
    return rec


def _event() -> torch.cuda.Event:
    return _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)


class _NoSpan:
    rec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "device", "rec", "rf", "start", "stream")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        self.rec = _new(self.name)
        self.start = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.start = _event()
            self.start.record(self.stream)
        _open().append(self)
        self.rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec.t1 = time.perf_counter_ns()
        _open().pop()
        if self.start is not None:
            end = _event()
            end.record(self.stream)
            _PENDING.append(_Interval(self.rec, self.start, end))
        self.rf.__exit__(*exc)
        _poll()
        return False


def span(name: str, device=None):
    """A host span, with the device interval of its work on ``device``
    (a card; None for host work or the CPU). A no-op when tracing is
    off."""
    if not on():
        return _NO_SPAN
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _Span(name, device)


def add_count(name: str, value, items: int = 1) -> None:
    """A counter record now, under the innermost open span (when
    tracing is on)."""
    if on():
        _new(name, value=value, items=items)


# --------------------------------------------------------------- layers

class Layers:
    """The marks of one step's body: (name, timing event, or host ns on
    the CPU), and its counters (name, value). ``stream``: the card's
    stream the step runs on (None on the CPU)."""

    def __init__(self, stream=None):
        self.stream = stream
        self.marks: list = []
        self.counts: list = []
        self._outer = None

    def mark(self, name: str, end: bool = False) -> None:
        if self.stream is None:
            self.marks.append((name, time.perf_counter_ns()))
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.marks.append((name, ev))

    def count(self, name: str, value) -> None:
        self.counts.append((name, value))

    def __enter__(self):
        self._outer, _COLLECTOR[0] = _COLLECTOR[0], self
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.mark("", end=True)  # the end of the last layer
        _COLLECTOR[0] = self._outer
        return False


class Captured(Layers):
    """The marks and counters of a step's body being captured on
    ``stream``, as nodes of its graph: each mark writes the card's clock
    into column i of the ring's current row (``stamps`` [RING, MAX_MARKS]
    int64 ns), a counter's tensor into the current column of the rows it
    takes of ``kept`` [MAX_KEPT, RING] int32 (so that the rows in use are
    one block to copy), and the end advances the row (``slot``, on the
    card). The host counts the replays
    (``replays``) and queues the traced ones, with an event recorded after
    each; they are read in one copy when the ring comes round on the
    oldest, and by ``summary()``. Made before the capture: it warms the
    kernels and
    allocates the rings outside the graph's pool, whose memory earlier
    nodes of the graph may write at every replay."""

    def __init__(self, stream):
        super().__init__(stream)
        from rvt_tpu_torch.ops import kernels
        self._lib = kernels.lib("trace_stamp")
        self._ptr, self._check = kernels.ptr, kernels.check
        self._raw = stream.cuda_stream
        with torch.cuda.stream(stream):
            self.stamps = torch.zeros(RING, MAX_MARKS, dtype=torch.int64,
                                      device=stream.device)
            self.kept = torch.zeros(MAX_KEPT, RING, dtype=torch.int32,
                                    device=stream.device)
            self.slot = torch.zeros(1, dtype=torch.int32,
                                    device=stream.device)
            self._stamp(0, False)
        self._used = 0
        _side(stream.device)  # made now, not in a traced window
        stream.synchronize()
        self.replays = 0
        self.pending: deque = deque()

    def _stamp(self, i: int, advance: bool) -> None:
        self._check(self._lib.rvt_trace_stamp(
            self._ptr(self.stamps), self._ptr(self.slot), i, MAX_MARKS,
            RING, int(advance), self._raw), "trace_stamp")

    def mark(self, name: str, end: bool = False) -> None:
        i = len(self.marks)
        if i >= MAX_MARKS:
            raise ValueError(f"a captured step makes at most {MAX_MARKS} "
                             f"marks")
        self._stamp(i, end)
        self.marks.append((name, i))

    def count(self, name: str, value) -> None:
        if not isinstance(value, torch.Tensor):
            self.counts.append((name, value))
            return
        src = value.reshape(-1).to(torch.int32).contiguous()
        at, n = self._used, src.numel()
        if at + n > MAX_KEPT:
            raise ValueError(f"a captured step keeps at most {MAX_KEPT} "
                             f"counter elements")
        self._check(self._lib.rvt_trace_keep(
            self._ptr(src), self._ptr(self.kept[at]), self._ptr(self.slot),
            n, RING, self._raw), "trace_keep")
        self._used = at + n
        self.counts.append((name, (at, n)))

    def before_replay(self) -> None:
        """Read the queued traced replays once the next replay would
        write the oldest one's row again: the oldest (done long ago) and
        every later one that is done, in one copy."""
        if self.pending and self.replays - self.pending[0][0] >= RING:
            self.read(wait=False)

    def after_replay(self, rec: Optional["Record"], device) -> None:
        """Count a replay; a traced one (``rec``, its span) is queued with
        an event recorded after it."""
        self.replays += 1
        if rec is None or not self.marks:
            return
        done = _event()
        done.record(torch.cuda.current_stream(device))
        self.pending.append((self.replays - 1, rec, done))
        _RINGS[id(self)] = self

    def read(self, wait: bool) -> None:
        """Read the queued replays that are done into records, from one
        copy of the rings: the oldest is waited for, and with ``wait``
        the newest (and so every one)."""
        self.pending[-1 if wait else 0][2].synchronize()
        items = []
        for k, rec, done in self.pending:
            if items and not done.query():
                break
            items.append((k, rec, done))
        n = len(self.marks)
        stamps = _to_host(self.stamps).tolist()
        kept = _to_host(self.kept[:self._used]) if self._used else None
        for k, rec, done in items:
            row = k % RING
            ns = stamps[row][:n]
            counts = [(name, kept[v[0]:v[0] + v[1], row]
                       if isinstance(v, tuple) else v)
                      for name, v in self.counts]
            layers = [(name, None, None, (b - a) * 1e-9)
                      for (name, _), a, b in zip(self.marks, ns, ns[1:])]
            _emit(rec, layers, (ns[-1] - ns[0]) * 1e-9, counts)
            _EVENTS.append(done)
            self.pending.popleft()
        if not self.pending:
            _RINGS.pop(id(self), None)


def layers(device=None) -> Layers:
    """The collector an eager step body's marks and counts go to, for a
    step on ``device`` (a card, or None), on its current stream."""
    stream = (torch.cuda.current_stream(device) if device is not None
              and torch.device(device).type == "cuda" else None)
    return Layers(stream)


def collecting() -> bool:
    """Whether a step's marks are being collected (a capture, or a
    traced eager step): counts made now are kept."""
    return _COLLECTOR[0] is not None


def mark(name: str) -> None:
    """End the step's current layer and start ``name``."""
    c = _COLLECTOR[0]
    if c is not None:
        c.mark(name)


def count(name: str, value) -> None:
    """A counter of the step being collected: ``value`` a number (one
    item) or a tensor, summed over its elements."""
    c = _COLLECTOR[0]
    if c is not None:
        c.count(name, value)


def mark_after_grads(tensors, name: str) -> None:
    """Mark ``name`` when the last of ``tensors`` that require a gradient
    has it (a hook on each; in the thread autograd runs in)."""
    c = _COLLECTOR[0]
    ts = [t for t in tensors if t.requires_grad]
    if c is None or not ts:
        return
    left = [len(ts)]

    def hook(grad):
        left[0] -= 1
        if left[0] == 0:
            c.mark(name)
    for t in ts:
        t.register_hook(hook)


# ----------------------------------------------------------- collection

class _Pending:
    done = False

    def last(self):
        raise NotImplementedError

    def ready(self) -> bool:
        ev = self.last()
        return ev is None or ev.query()

    def wait(self) -> None:
        ev = self.last()
        if ev is not None:
            ev.synchronize()


class _Interval(_Pending):
    """A span's device interval: a start and an end event."""

    def __init__(self, rec: Record, start, end):
        self.rec, self.start, self.end = rec, start, end

    def last(self):
        return self.end

    def collect(self) -> None:
        self.rec.device_s = self.start.elapsed_time(self.end) * 1e-3
        _EVENTS.extend((self.start, self.end))
        self.done = True


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A card's tensor read on a side stream: the step's work that wrote
    it is done, the compute stream may hold later work."""
    if not t.is_cuda:
        return t
    with torch.cuda.stream(_side(t.device)):
        return t.to("cpu")


def _side(device) -> torch.cuda.Stream:
    """The side stream the rings and counters of ``device`` are read on."""
    index = torch.device(device).index
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(device)
    return _SIDE[index]


def _total(value) -> tuple:
    """(sum, elements) of a counter's value."""
    if not isinstance(value, torch.Tensor):
        return value, 1
    value = _to_host(value)
    return int(value.sum()), value.numel()


def _emit(rec: Record, layers, total_s, counts) -> None:
    """A step run's layers ((name, host t0, t1, device s)) as records
    under its span ``rec``, whose device interval is ``total_s``, and its
    counters ((name, value)) summed by name beside ``rec``."""
    for name, t0, t1, dev in layers:
        _RECORDS.append(Record(name, rec.name, rec.call, pid=rec.rid,
                               t0=t0, t1=t1, device_s=dev))
    if total_s is not None:
        rec.device_s = total_s
    sums: Dict[str, list] = {}
    for name, value in counts:
        v, n = _total(value)
        s = sums.setdefault(name, [0, 0])
        s[0] += v
        s[1] += n
    for name, (v, n) in sums.items():
        _RECORDS.append(Record(name, rec.parent, rec.call, pid=rec.pid,
                               value=v, items=n))


class _Marks(_Pending):
    """One eager run of a step's layers: its marks and counters, read
    into layer records under the step's span (``rec``) and counter
    records beside them."""

    def __init__(self, marks, counts, rec: Record):
        self.marks, self.counts, self.rec = marks, counts, rec

    def last(self):
        t = self.marks[-1][1] if self.marks else None
        return None if isinstance(t, int) else t

    def collect(self) -> None:
        pairs = list(zip(self.marks, self.marks[1:]))
        if self.last() is None:  # the host clock
            layers = [(n, a, b, None) for (n, a), (_, b) in pairs]
            total = None
        else:
            layers = [(n, None, None, a.elapsed_time(b) * 1e-3)
                      for (n, a), (_, b) in pairs]
            total = self.marks[0][1].elapsed_time(self.marks[-1][1]) * 1e-3
        _emit(self.rec, layers, total, self.counts)
        self.done = True


def queue_layers(c: Layers, rec: Optional[Record]) -> None:
    """After a traced eager run of a step: its layers under span ``rec``,
    read now on the CPU, else once its last event is done."""
    if rec is None or not c.marks:
        return
    item = _Marks(c.marks, c.counts, rec)
    if item.last() is None:
        item.collect()
    else:
        _PENDING.append(item)


def _poll() -> None:
    """Read what is done, oldest first, without waiting."""
    while _PENDING and (_PENDING[0].done or _PENDING[0].ready()):
        item = _PENDING.pop(0)
        if not item.done:
            item.collect()


def _collect_all() -> None:
    while _PENDING:
        item = _PENDING.pop(0)
        if not item.done:
            item.wait()
            item.collect()
    for c in list(_RINGS.values()):
        c.read(wait=True)


# --------------------------------------------------------------- reading

def records() -> List[Record]:
    """The records kept, in the order they were made (layers and counters
    when their step's marks were read)."""
    return list(_RECORDS)


def reset() -> None:
    """Drop every record and what is pending."""
    _RECORDS.clear()
    _PENDING.clear()
    for c in _RINGS.values():
        c.pending.clear()
    _RINGS.clear()


def summary() -> dict:
    """Collect what is pending, then sum the records by name:
    ``{"spans": {name: {count, host_s, self_s, device_s, device_count}},
    "counters": {name: {sum, items, count}}}``. ``self_s`` is a span's
    host time less its children's; ``device_s`` sums the device durations
    of the ``device_count`` records that have one."""
    _collect_all()
    recs = list(_RECORDS)

    def host(r):
        return (r.t1 - r.t0) if r.t0 is not None and r.t1 is not None else 0
    children: Dict[int, int] = defaultdict(int)
    for r in recs:
        if r.value is None and r.pid is not None:
            children[r.pid] += host(r)
    spans: Dict[str, dict] = {}
    counters: Dict[str, dict] = {}
    for r in recs:
        if r.value is not None:
            c = counters.setdefault(r.name, {"sum": 0, "items": 0,
                                             "count": 0})
            c["sum"] += r.value
            c["items"] += r.items
            c["count"] += 1
            continue
        s = spans.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0, "device_s": 0.0,
                                      "device_count": 0})
        s["count"] += 1
        s["host_s"] += host(r) * 1e-9
        s["self_s"] += (host(r) - children[r.rid]) * 1e-9
        if r.device_s is not None:
            s["device_s"] += r.device_s
            s["device_count"] += 1
    return {"spans": spans, "counters": counters}

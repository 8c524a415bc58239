"""Raw Prophesee event-file readers (.dat Event2D and structured .npy; a
copy of ``rvt_tpu.data.psee_loader``).

Clean-room equivalent of the reference raw-dataset tooling
(``utils/evaluation/prophesee/io/psee_loader.py`` + ``dat_events_tools.py``
+ ``npy_events_tools.py``, ~570 LoC): used to inspect/convert raw downloads,
not in the training path.

.dat binary layout (Prophesee StreamLogger 'Event2D'):
  * ASCII header lines starting with '%' (may carry "% Height"/"% Width"),
  * 1 byte event type (0 = Event2D) + 1 byte event size (8),
  * packed little-endian records: uint32 timestamp_us, int32 data where
    x = data & 0x3FFF, y = (data >> 14) & 0x3FFF, p = (data >> 28) & 1.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

EVENT_DTYPE = np.dtype([("t", "<u4"), ("data", "<i4")])


def _parse_dat_header(f) -> Tuple[int, int, int, Optional[int], Optional[int]]:
    """Returns (data_start_offset, ev_type, ev_size, height, width)."""
    height = width = None
    while True:
        pos = f.tell()
        line = f.readline()
        if not line.startswith(b"%"):
            f.seek(pos)
            break
        text = line.decode(errors="ignore").strip("% \r\n")
        if text.lower().startswith("height"):
            height = int(text.split()[-1])
        elif text.lower().startswith("width"):
            width = int(text.split()[-1])
    header = f.read(2)
    if len(header) == 2:
        ev_type, ev_size = header[0], header[1]
    else:  # headerless legacy files
        ev_type, ev_size = 0, 8
        f.seek(pos)
    return f.tell(), ev_type, ev_size, height, width


def unpack_events(raw: np.ndarray) -> Dict[str, np.ndarray]:
    """Packed records -> dict of t/x/y/p int arrays."""
    return {
        "t": raw["t"].astype(np.int64),
        "x": (raw["data"] & 0x3FFF).astype(np.int32),
        "y": ((raw["data"] >> 14) & 0x3FFF).astype(np.int32),
        "p": ((raw["data"] >> 28) & 1).astype(np.int32),
    }


def write_dat(path: Path, t, x, y, p, height: int, width: int) -> None:
    """Write an Event2D .dat file (for fixtures/tooling round-trips)."""
    with open(path, "wb") as f:
        f.write(b"% Data file\n")
        f.write(f"% Height {height}\n".encode())
        f.write(f"% Width {width}\n".encode())
        f.write(bytes([0, 8]))
        raw = np.empty(len(t), EVENT_DTYPE)
        raw["t"] = np.asarray(t, np.uint32)
        raw["data"] = (np.asarray(x, np.int32) |
                       (np.asarray(y, np.int32) << 14) |
                       (np.asarray(p, np.int32) << 28))
        raw.tofile(f)


class PSEELoader:
    """Chunked reader over a .dat event file with time/count seeking
    (mirror of the reference PSEELoader API)."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        (self._start, self.ev_type, self.ev_size,
         self.height, self.width) = _parse_dat_header(self._f)
        assert self.ev_size == EVENT_DTYPE.itemsize, self.ev_size
        self._f.seek(0, 2)
        self._num_events = (self._f.tell() - self._start) // self.ev_size
        self._f.seek(self._start)
        self._done = self._num_events == 0
        # total duration (last event's time)
        if self._num_events:
            self._f.seek(self._start + (self._num_events - 1) * self.ev_size)
            last = np.fromfile(self._f, EVENT_DTYPE, 1)
            self.total_time_us = int(last["t"][0])
            self._f.seek(self._start)
        else:
            self.total_time_us = 0

    def event_count(self) -> int:
        return self._num_events

    def total_time(self) -> int:
        return self.total_time_us

    def done(self) -> bool:
        return self._done

    def current_event_index(self) -> int:
        return (self._f.tell() - self._start) // self.ev_size

    def seek_event(self, index: int) -> None:
        index = int(np.clip(index, 0, self._num_events))
        self._f.seek(self._start + index * self.ev_size)
        self._done = index >= self._num_events

    def seek_time(self, t_us: int) -> None:
        """Binary search to the first event with time >= t_us."""
        lo, hi = 0, self._num_events
        while lo < hi:
            mid = (lo + hi) // 2
            self._f.seek(self._start + mid * self.ev_size)
            rec = np.fromfile(self._f, EVENT_DTYPE, 1)
            if int(rec["t"][0]) < t_us:
                lo = mid + 1
            else:
                hi = mid
        self.seek_event(lo)

    def load_n_events(self, n: int) -> Dict[str, np.ndarray]:
        raw = np.fromfile(self._f, EVENT_DTYPE, int(n))
        self._done = self.current_event_index() >= self._num_events
        return unpack_events(raw)

    def load_delta_t(self, delta_t_us: int) -> Dict[str, np.ndarray]:
        """Load all events within the next delta_t microseconds."""
        if self._done:
            return unpack_events(np.empty(0, EVENT_DTYPE))
        pos = self.current_event_index()
        self._f.seek(self._start + pos * self.ev_size)
        first = np.fromfile(self._f, EVENT_DTYPE, 1)
        t_end = int(first["t"][0]) + delta_t_us
        self.seek_time(t_end)
        end = self.current_event_index()
        self._f.seek(self._start + pos * self.ev_size)
        raw = np.fromfile(self._f, EVENT_DTYPE, end - pos)
        self._done = end >= self._num_events
        return unpack_events(raw)

    def close(self):
        self._f.close()


def load_npy_events(path) -> np.ndarray:
    """Load a structured .npy event/box file, normalising legacy field
    names ('ts' -> 't', 'confidence' -> 'class_confidence'), mirroring
    npy_events_tools.parse_header + box_loading.reformat_boxes."""
    arr = np.load(str(path))
    names = list(arr.dtype.names)
    rename = {"ts": "t", "confidence": "class_confidence"}
    if any(n in rename for n in names):
        new_names = [rename.get(n, n) for n in names]
        arr = arr.copy()
        arr.dtype.names = tuple(new_names)
    return arr

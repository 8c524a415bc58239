"""HDF5-backed recording readers (preprocessed Prophesee format; a copy
of ``rvt_tpu.data.sequence``).

On-disk layout per recording (documented at the reference
``data/genx_utils/sequence_base.py:32-43``):

    <recording>/
      event_representations_v2/<repr_name>/
        event_representations[_ds2_nearest].h5   dataset 'data': [T, C, H, W]
        objframe_idx_2_repr_idx.npy
        timestamps_us.npy
      labels_v2/
        labels.npz   ('labels' structured array + 'objframe_idx_2_label_idx')
        timestamps_us.npy

Deltas vs the reference readers:
  * windows come back as dense padded arrays ([T, C, H, W] + label pads +
    masks) ready to stack into a ``Batch`` — no per-step Python lists,
  * the h5 file handle is kept open per reader (the reference re-opens the
    file on every read, sequence_base.py:92-102),
  * labels are padded to ``max_labels_per_frame`` with masks.
"""
from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

from rvt_tpu_torch.data import blosc_h5
from rvt_tpu_torch.data.labels import LabelStore, pad_labels
from rvt_tpu_torch.data.types import Batch

# Published datasets are blosc-zstd compressed (reference
# utils/preprocessing.py:1-13); make the first-party filter available to
# every h5py.File opened from here on.
blosc_h5.register_plugin()


def _ev_repr_file(path: Path, repr_name: str, downsample_by_factor_2: bool) -> Path:
    d = path / "event_representations_v2" / repr_name
    suffix = "_ds2_nearest" if downsample_by_factor_2 else ""
    return d / f"event_representations{suffix}.h5"


class Recording:
    """One preprocessed recording: lazy event-tensor reads + label lookup."""

    def __init__(self, path: Path, repr_name: str, original_hw: Tuple[int, int],
                 downsample_by_factor_2: bool = False,
                 max_labels_per_frame: int = 48,
                 prefer_raw_chunks: bool = False):
        assert h5py is not None, "h5py required for the HDF5 data layer"
        self.path = Path(path)
        self.max_labels = max_labels_per_frame
        # decode blosc chunks outside h5py's global lock so threaded
        # loaders scale (see blosc_h5.open_data_dataset)
        self.prefer_raw_chunks = prefer_raw_chunks
        self.ev_file = _ev_repr_file(self.path, repr_name, downsample_by_factor_2)
        assert self.ev_file.exists(), self.ev_file

        label_data = np.load(str(self.path / "labels_v2" / "labels.npz"))
        self.label_store = LabelStore.from_structured_array(
            label_data["labels"], label_data["objframe_idx_2_label_idx"],
            input_size_hw=original_hw,
            downsample_factor=2 if downsample_by_factor_2 else None)

        repr_dir = self.ev_file.parent
        self.objframe_idx_2_repr_idx = np.load(
            str(repr_dir / "objframe_idx_2_repr_idx.npy"))
        self.repr_idx_2_objframe_idx: Dict[int, int] = {
            int(r): i for i, r in enumerate(self.objframe_idx_2_repr_idx)}

        self._h5: Optional["h5py.File"] = None
        self._data = None
        self._open_lock = threading.Lock()
        with h5py.File(str(self.ev_file), "r") as f:
            ds = f["data"]
            self.num_ev_repr = ds.shape[0]
            self.ev_shape = tuple(ds.shape[1:])  # (C, H, W)
            self.ev_dtype = ds.dtype

    # -- event tensors ------------------------------------------------------

    def _handle(self):
        if self._data is None:
            with self._open_lock:  # threaded loaders race the lazy open
                if self._data is None:
                    h5 = h5py.File(str(self.ev_file), "r")
                    self._data = blosc_h5.open_data_dataset(
                        h5, prefer_raw_chunks=self.prefer_raw_chunks)
                    self._h5 = h5
        return self._data

    def read_ev_repr(self, start: int, end: int) -> np.ndarray:
        assert 0 <= start < end <= self.num_ev_repr
        return np.asarray(self._handle()[start:end])

    def close(self) -> None:
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
            self._data = None

    # h5py handles and locks cannot cross process boundaries; drop them on
    # pickle, reopen lazily in the receiving process (loader.py process mode)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_h5"] = None
        state["_data"] = None
        del state["_open_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_lock = threading.Lock()

    # -- labels -------------------------------------------------------------

    def labels_at_repr_idx(self, repr_idx: int) -> Optional[np.ndarray]:
        objframe_idx = self.repr_idx_2_objframe_idx.get(repr_idx)
        if objframe_idx is None:
            return None
        labels = self.label_store[objframe_idx]
        return labels if len(labels) else None

    # -- window assembly ----------------------------------------------------

    def read_window(self, start: int, end: int, seq_len: int,
                    is_first_sample: bool) -> Dict[str, np.ndarray]:
        """Read repr frames [start, end) and pad to seq_len.

        Returns dense per-window arrays (see data/types.py Batch fields,
        minus the batch dim). Mirrors SequenceForIter.__getitem__
        (sequence_for_streaming.py:141-185) with padded-array output.
        """
        sample_len = end - start
        assert 0 < sample_len <= seq_len
        C, H, W = self.ev_shape
        ev = np.zeros((seq_len, C, H, W), self.ev_dtype)
        ev[:sample_len] = self.read_ev_repr(start, end)

        labels = np.zeros((seq_len, self.max_labels, 7), np.float32)
        label_mask = np.zeros((seq_len, self.max_labels), bool)
        for t, repr_idx in enumerate(range(start, end)):
            lab = self.labels_at_repr_idx(repr_idx)
            if lab is not None:
                labels[t], label_mask[t] = pad_labels(lab, self.max_labels)

        is_padded = np.zeros((seq_len,), bool)
        is_padded[sample_len:] = True
        return {
            "ev_repr": ev,
            "labels": labels,
            "label_mask": label_mask,
            "frame_valid": label_mask.any(-1),
            "is_first_sample": np.asarray(is_first_sample),
            "is_padded": is_padded,
        }

    def padded_window(self, seq_len: int) -> Dict[str, np.ndarray]:
        """Fully padded fill window (stream tail filler,
        sequence_for_streaming.py:124-136)."""
        C, H, W = self.ev_shape
        return {
            "ev_repr": np.zeros((seq_len, C, H, W), self.ev_dtype),
            "labels": np.zeros((seq_len, self.max_labels, 7), np.float32),
            "label_mask": np.zeros((seq_len, self.max_labels), bool),
            "frame_valid": np.zeros((seq_len,), bool),
            "is_first_sample": np.asarray(False),
            "is_padded": np.ones((seq_len,), bool),
        }


def ev_repr_range_indices(indices: np.ndarray, max_len: int) -> List[Tuple[int, int]]:
    """Split a recording into label-dense index ranges so every train window
    of length ``max_len`` contains >= 1 label. Mirrors
    ``_get_ev_repr_range_indices`` (sequence_for_streaming.py:25-54)."""
    stops = np.flatnonzero(np.diff(indices) > max_len)
    starts = np.concatenate(([0], stops + 1))
    stops = np.concatenate((stops, [len(indices) - 1]))
    out = []
    for s, e in zip(starts, stops):
        out.append((max(int(indices[s]) - max_len + 1, 0), int(indices[e]) + 1))
    return out


class StreamView:
    """Consecutive seq_len windows over (a range of) one recording.

    Mirrors ``SequenceForIter`` (sequence_for_streaming.py:57-185): window 0
    carries ``is_first_sample=True`` (resets LSTM state downstream); the
    tail window is zero-padded.
    """

    def __init__(self, recording: Recording, seq_len: int,
                 range_indices: Optional[Tuple[int, int]] = None):
        self.rec = recording
        self.seq_len = seq_len
        first_label_repr = int(recording.objframe_idx_2_repr_idx[0])
        min_start = max(first_label_repr - seq_len + 1, 0)
        if range_indices is None:
            start, stop = min_start, recording.num_ev_repr
        else:
            start, stop = range_indices
        assert 0 <= min_start <= start < stop <= recording.num_ev_repr
        self.start_indices = list(range(start, stop, seq_len))
        self.stop_indices = self.start_indices[1:] + [stop]

    def __len__(self) -> int:
        return len(self.start_indices)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.rec.read_window(self.start_indices[i], self.stop_indices[i],
                                    self.seq_len, is_first_sample=(i == 0))

    @staticmethod
    def with_guaranteed_labels(recording: Recording, seq_len: int) -> List["StreamView"]:
        """Label-dense sub-streams for training
        (sequence_for_streaming.py:90-115)."""
        ranges = ev_repr_range_indices(recording.objframe_idx_2_repr_idx, seq_len)
        return [StreamView(recording, seq_len, r) for r in ranges]


class RandomAccessView:
    """Random-access samples: the seq_len frames *ending at* each labelled
    frame; state always reset. Mirrors ``SequenceForRandomAccess``
    (sequence_rnd.py:9-85)."""

    def __init__(self, recording: Recording, seq_len: int,
                 only_load_end_labels: bool = False):
        self.rec = recording
        self.seq_len = seq_len
        self.only_load_end_labels = only_load_end_labels
        # skip labelled frames whose repr_idx < seq_len - 1 cannot be used:
        # reference starts at the first objframe with repr_idx >= seq_len-1
        # (sequence_rnd.py:30-38 equivalent behaviour)
        self.valid_objframe_indices = np.flatnonzero(
            recording.objframe_idx_2_repr_idx >= seq_len - 1)

    def __len__(self) -> int:
        return len(self.valid_objframe_indices)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        objframe_idx = int(self.valid_objframe_indices[i])
        end_repr = int(self.rec.objframe_idx_2_repr_idx[objframe_idx]) + 1
        start_repr = end_repr - self.seq_len
        out = self.rec.read_window(start_repr, end_repr, self.seq_len,
                                   is_first_sample=True)
        if self.only_load_end_labels:
            out["labels"][:-1] = 0.0
            out["label_mask"][:-1] = False
            out["frame_valid"] = out["label_mask"].any(-1)
        return out

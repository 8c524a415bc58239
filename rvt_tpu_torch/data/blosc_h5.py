"""Blosc-compressed HDF5 support (filter id 32001) without hdf5plugin (a
copy of ``rvt_tpu.data.blosc_h5``).

The published preprocessed RVT datasets store event tensors as blosc-zstd
compressed HDF5 chunks (written by the reference via hdf5plugin:
upstream ``utils/preprocessing.py:1-13``, read at
``data/genx_utils/sequence_base.py:92-102``). hdf5plugin and
python-blosc are not installed in this image, so this module provides two
first-party paths backed by the system ``libblosc.so.1``:

1. **HDF5 filter plugin** (``native/libh5blosc.so``): registered onto h5py's
   plugin search path, making blosc datasets transparently readable *and*
   writable through the normal h5py API. This is the production path.
2. **ctypes fallback reader**: if the plugin .so has not been built, chunks
   are read raw via ``read_direct_chunk`` and decompressed with
   ``blosc_decompress_ctx`` through ctypes. Read-only.

``blosc_opts`` mirrors the reference ``_blosc_opts`` (same cd_values layout,
so files we write are readable by hdf5plugin and vice versa).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

BLOSC_FILTER_ID = 32001
_COMPRESSORS = ["blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd"]
_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

_plugin_registered: Optional[bool] = None


def register_plugin() -> bool:
    """Add native/ to HDF5's dynamic-plugin search path (idempotent).

    Returns True if the blosc filter is usable through h5py afterwards.
    """
    global _plugin_registered
    if _plugin_registered is not None:
        return _plugin_registered
    if h5py is None or not (_NATIVE_DIR / "libh5blosc.so").exists():
        _plugin_registered = False
        return False
    try:
        h5py.h5pl.prepend(bytes(_NATIVE_DIR))
        _plugin_registered = bool(h5py.h5z.filter_avail(BLOSC_FILTER_ID))
    except Exception:  # pragma: no cover - defensive
        _plugin_registered = False
    return _plugin_registered


def blosc_opts(complevel: int = 1, complib: str = "blosc:zstd",
               shuffle: str = "byte") -> dict:
    """h5py ``create_dataset`` kwargs for blosc compression.

    Reference-identical cd_values layout (utils/preprocessing.py:1-13):
    (0, 0, 0, 0, complevel, shuffle, compcode). Our filter plugin has no
    set_local hook, so cd_values[2] (typesize) stays 0 and the plugin
    shuffles on byte granularity — identical behaviour for the uint8/int8
    event tensors this format stores (typesize 1).
    """
    shuffle_code = 2 if shuffle == "bit" else 1 if shuffle == "byte" else 0
    compcode = _COMPRESSORS.index(complib.split(":")[1])
    args = {
        "compression": BLOSC_FILTER_ID,
        "compression_opts": (0, 0, 0, 0, complevel, shuffle_code, compcode),
    }
    if shuffle_code > 0:
        args["shuffle"] = False
    return args


# ---------------------------------------------------------------------------
# ctypes fallback reader (plugin .so not built)
# ---------------------------------------------------------------------------

_libblosc = None


def _blosc() -> ctypes.CDLL:
    global _libblosc
    if _libblosc is None:
        _libblosc = ctypes.CDLL("libblosc.so.1")
        _libblosc.blosc_decompress_ctx.restype = ctypes.c_int
        _libblosc.blosc_decompress_ctx.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    return _libblosc


def decompress_chunk(raw: bytes, out_nbytes: int) -> np.ndarray:
    """Decompress one raw blosc chunk to a uint8 array of out_nbytes."""
    out = np.empty(out_nbytes, np.uint8)
    rc = _blosc().blosc_decompress_ctx(
        raw, out.ctypes.data_as(ctypes.c_void_p), out.nbytes, 1)
    if rc != out_nbytes:
        raise OSError(f"blosc_decompress_ctx failed (rc={rc}, want {out_nbytes})")
    return out


def dataset_uses_blosc(ds) -> bool:
    plist = ds.id.get_create_plist()
    for i in range(plist.get_nfilters()):
        if plist.get_filter(i)[0] == BLOSC_FILTER_ID:
            return True
    return False


class BloscChunkDataset:
    """Read-only axis-0 sliceable view over a blosc-compressed HDF5 dataset,
    decoding chunks via ctypes libblosc (no HDF5 filter plugin needed).

    Requires the dataset to be chunked along axis 0 only (the preprocessed
    format stores one frame per chunk: chunks=(1, C, H, W))."""

    def __init__(self, ds):
        self.ds = ds
        self.shape: Tuple[int, ...] = ds.shape
        self.dtype = ds.dtype
        chunks = ds.chunks
        assert chunks is not None and tuple(chunks[1:]) == tuple(ds.shape[1:]), \
            f"fallback reader needs axis-0-only chunking, got {chunks}"
        self.chunk0 = chunks[0]
        self._frame_nbytes = int(np.prod(ds.shape[1:])) * ds.dtype.itemsize
        self._zeros = (0,) * (len(ds.shape) - 1)
        # read_direct_chunk runs outside h5py's global lock and races with
        # every other HDF5 call of the process: on one dataset in its
        # metadata cache ("Target already protected"), across datasets and
        # other h5py calls in its VOL layer ("no VOL object wrap
        # context"). So the raw IO takes h5py's own lock (JAX's copy locks
        # per dataset and still races across recordings); the blosc
        # decompress below stays parallel (ctypes, GIL released), which
        # is the expensive part.
        self._io_lock = h5py._objects.phil

    def __len__(self) -> int:
        return self.shape[0]

    def _read_chunk(self, chunk_idx: int) -> np.ndarray:
        with self._io_lock:
            _, raw = self.ds.id.read_direct_chunk(
                (chunk_idx * self.chunk0,) + self._zeros)
        flat = decompress_chunk(raw, self.chunk0 * self._frame_nbytes)
        return flat.view(self.dtype).reshape((self.chunk0,) + self.shape[1:])

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            arr = self[int(key):int(key) + 1]
            return arr[0]
        assert isinstance(key, slice), f"unsupported index {key!r}"
        start, stop, step = key.indices(self.shape[0])
        assert step == 1, "fallback reader supports contiguous slices only"
        n = max(stop - start, 0)
        out = np.empty((n,) + self.shape[1:], self.dtype)
        c0, pos = self.chunk0, 0
        for chunk_idx in range(start // c0, (stop + c0 - 1) // c0 if n else 0):
            chunk = self._read_chunk(chunk_idx)
            lo = max(start - chunk_idx * c0, 0)
            hi = min(stop - chunk_idx * c0, c0)
            out[pos:pos + hi - lo] = chunk[lo:hi]
            pos += hi - lo
        assert pos == n
        return out


def open_data_dataset(h5_file, name: str = "data",
                      prefer_raw_chunks: bool = False):
    """Return an axis-0 sliceable dataset view: the plain h5py dataset when
    its filters are readable, else the ctypes blosc fallback.

    ``prefer_raw_chunks``: use the ctypes chunk reader even when the HDF5
    filter plugin is available. The plugin decompresses inside the HDF5
    read call, i.e. under h5py's global lock (``phil``) — concurrent
    reader threads serialize on the decode. The chunk reader only holds
    the lock for ``read_direct_chunk`` (raw IO) and decompresses through
    ctypes with the GIL released, so thread-mode loaders
    (data/loader.py) scale with cores. Same bytes either way
    (tests/test_blosc.py)."""
    ds = h5_file[name]
    if dataset_uses_blosc(ds) and (prefer_raw_chunks or not register_plugin()):
        return BloscChunkDataset(ds)
    return ds

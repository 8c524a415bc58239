"""ctypes loader for the native host kernels (native/rvt_native.cpp; a
copy of ``rvt_tpu.native_lib``).

Builds the shared library on first use if g++ is available; every consumer
has a pure-numpy fallback, so the framework works without a compiler.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "librvt_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # this library's target alone: the HDF5 filter plugin beside it links
    # libblosc, which a machine may lack, and would fail the whole make
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR), _LIB_PATH.name],
                       check=True, capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.coco_match_image.argtypes = [
        c_f64p, ctypes.c_int, ctypes.c_int, c_u8p, c_f64p, ctypes.c_int,
        c_u8p, c_u8p, c_u8p]
    lib.coco_match_image.restype = None
    lib.stacked_histogram_u8.argtypes = [
        c_i32p, c_i32p, c_i32p, c_i64p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_u8p]
    lib.stacked_histogram_u8.restype = None
    c_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.mixed_density_stack_i8.argtypes = [
        c_i32p, c_i32p, c_i32p, c_i64p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, c_i8p]
    lib.mixed_density_stack_i8.restype = None
    lib.time_running_max.argtypes = [c_i64p, ctypes.c_int64]
    lib.time_running_max.restype = None
    _lib = lib
    return _lib


def coco_match_image(ious: np.ndarray, gt_ignore: np.ndarray,
                     thrs: np.ndarray, dt_out_of_range: np.ndarray):
    """Native greedy matcher. Returns (matched [T,D] bool, ignored [T,D]
    bool) or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    D, G = ious.shape
    T = len(thrs)
    matched = np.zeros((T, D), np.uint8)
    ignored = np.zeros((T, D), np.uint8)
    lib.coco_match_image(
        np.ascontiguousarray(ious, np.float64), D, G,
        np.ascontiguousarray(gt_ignore, np.uint8),
        np.ascontiguousarray(thrs, np.float64), T,
        np.ascontiguousarray(dt_out_of_range, np.uint8), matched, ignored)
    return matched.astype(bool), ignored.astype(bool)


def stacked_histogram_u8(x, y, p, t, bins: int, height: int, width: int,
                         count_cutoff: int = 255, fastmode: bool = False):
    """fastmode=True reproduces the reference default exactly (uint8
    accumulation wrapping mod 256 on >255-event cells, then clamp);
    fastmode=False saturates at count_cutoff."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(2 * bins * height * width, np.uint8)
    n = len(x)
    lib.stacked_histogram_u8(
        np.ascontiguousarray(x, np.int32), np.ascontiguousarray(y, np.int32),
        np.ascontiguousarray(p, np.int32), np.ascontiguousarray(t, np.int64),
        n, bins, height, width, count_cutoff, int(fastmode), out)
    return out.reshape(2 * bins, height, width)


def mixed_density_stack_i8(x, y, p, t, bins: int, height: int, width: int,
                           count_cutoff: Optional[int] = None):
    """MixedDensityEventStack (reference representations.py:130-218): int8
    wrap accumulation of +/-1 polarity, per-channel prefix sums wrap-cast to
    int8, clamp to +/-count_cutoff when given."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(bins * height * width, np.int8)
    lib.mixed_density_stack_i8(
        np.ascontiguousarray(x, np.int32), np.ascontiguousarray(y, np.int32),
        np.ascontiguousarray(p, np.int32), np.ascontiguousarray(t, np.int64),
        len(x), bins, height, width,
        -1 if count_cutoff is None else int(count_cutoff), out)
    return out.reshape(bins, height, width)


def time_running_max(t: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(t, np.int64)
    lib.time_running_max(t, len(t))
    return t

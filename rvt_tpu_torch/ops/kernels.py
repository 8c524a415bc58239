"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. Nothing is built at
import: the first launch of a kernel builds its library, or
``build_all()`` builds every one, one ``nvcc`` process per source, all
started together. Libraries go to ``build/kernels/`` at the repository
root (listed in ``.gitignore``), named by the hash of the source and its
headers, so an unchanged source is not rebuilt.

Every exported C function returns ``cudaGetLastError()`` after its
launch; ``check`` raises on a nonzero value.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("ln_rows", "gemm_bf16", "partition_attention", "lstm_scan",
           "stacked_histogram", "ln_rows_bwd", "gemm_bf16_wgrad",
           "partition_attention_bwd", "lstm_scan_bwd", "train_reduce",
           "nms_keep", "trace_stamp", "window_s2d", "bn_act")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
# train_reduce's plan arguments: chunks, rows a chunk, vec, tx, ty
# (``fused_attention.reduce_plan``)
_REDUCE_PLAN = (_I, _L, _I, _I, _I)
# The exported launchers of each source and their C signatures
# (argtypes); each returns an int, cudaGetLastError() after the launch.
SIGNATURES = {
    "ln_rows": {"rvt_ln_rows": (_P, _I, _P, _P, _P, _P, _L, _I, _F)
                + (_I,) * 4 + (_P,)},
    "gemm_bf16": {"rvt_gemm_bf16": (_P,) * 8 + (_I,) * 5 + (_P,),
                  "rvt_gemm_bf16_plan": (_I,) * 4 + (_P,)},
    "partition_attention": {
        "rvt_partition_attention": (_P, _P) + (_I,) * 8 + (_F, _P)},
    "lstm_scan": {"rvt_lstm_scan": (_P, _I) + (_P,) * 9 + (_I,) * 3
                  + (_P,),
                  "rvt_lstm_scan_plan": (_I,) * 5 + (_P,)},
    "stacked_histogram": {
        "rvt_stacked_histogram": (_P,) * 8 + (_I,) * 10 + (_P,)},
    "ln_rows_bwd": {"rvt_ln_rows_bwd": (_P, _I, _P, _P, _F, _P, _P, _P, _L,
                                        _I, _I, _P)},
    "gemm_bf16_wgrad": {"rvt_gemm_bf16_wgrad": (_P, _P, _P, _L, _I, _I, _I,
                                                _L, _P)},
    "partition_attention_bwd": {
        "rvt_partition_attention_bwd": (_P, _P, _P) + (_I,) * 8 + (_F, _P)},
    "lstm_scan_bwd": {"rvt_lstm_bwd_pack": (_P, _I) + (_P,) * 3
                      + (_I,) * 3 + (_P,),
                      "rvt_lstm_bwd_scan": (_P,) * 11 + (_I,) * 5 + (_P,),
                      "rvt_lstm_bwd_scan_plan": (_I,) * 3 + (_P,)},
    "train_reduce": {
        "rvt_sum_parts": (_P, _P, _L, _L) + _REDUCE_PLAN + (_P, _P, _P),
        "rvt_colsum": (_P, _I, _P, _L, _L) + _REDUCE_PLAN + (_P, _P, _P),
        "rvt_ls_bwd": (_P, _P, _P, _P, _P, _L, _I) + _REDUCE_PLAN
        + (_P, _P, _P)},
    "nms_keep": {"rvt_nms_keep": (_P, _P, _P, _P, _I, _I, _F, _P)},
    "trace_stamp": {"rvt_trace_stamp": (_P, _P) + (_I,) * 4 + (_P,),
                    "rvt_trace_keep": (_P, _P, _P, _I, _I, _P)},
    "window_s2d": {"rvt_window_s2d": (_P, _P) + (_I,) * 5 + (_L,) * 5
                   + (_I, _I, _P)},
    # y, y_f32 first; the shape (chw, N, C, S, vec); a reduction's plan
    # (chunks, rows, tx) or an elementwise pass's grid (``ops/bn_act.py``)
    "bn_act": {
        "rvt_bn_moments": (_P, _I, _P) + (_I,) * 5 + (_I, _L, _I)
        + (_P, _P, _P),
        "rvt_bn_act_fwd": (_P, _I) + (_P,) * 6 + (_I,) * 6 + (_F,) * 4
        + (_I, _P),
        "rvt_bn_act_bwd_sums": (_P, _I, _P, _I) + (_P,) * 5 + (_I,) * 5
        + (_I, _L, _I) + (_F, _F, _I) + (_P, _P, _P),
        "rvt_bn_act_bwd_dy": (_P, _I, _P, _I) + (_P,) * 5 + (_I,) * 6
        + (_F, _F, _I, _P)},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
COUNTERS: List["Counter"] = []
TALLIES: List["Counter"] = []
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cand:
        p = Path(root) / "bin" / "nvcc"
        if root and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source that is not built yet, one nvcc each, all
    running at once; raises if any build fails."""
    jobs = {n: _start(n) for n in SOURCES}
    errors = []
    for n in SOURCES:
        try:
            _finish(n, jobs[n])
        except RuntimeError as e:  # collect, then raise once all have ended
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _finish(name, _start(name))
        cdll = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(cdll, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = cdll
    return _LIBS[name]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def need(cond: bool, what: str) -> None:
    """Raise ValueError(what) unless ``cond``: the wrappers' operand checks."""
    if not cond:
        raise ValueError(what)


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        # the message only on failure: formatting it is most of a
        # launch's host time on the small T = 1 calls
        if not (t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"{name}: every operand must be a contiguous, 16-byte "
                f"aligned CUDA tensor (got {t.device}, {tuple(t.shape)})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on the card ``t`` lies on, as the raw
    pointer (the accessor PyTorch's generated code uses: building a
    ``torch.cuda.Stream`` costs several microseconds of host time a
    launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of the card ``t`` lies on (K6 sizes its
    splits, K1 its grid by it)."""
    return _sm_count(t.get_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {err}")


# Workspaces replaced by larger ones: a captured graph may still write
# them, so they stay allocated while the process lives
_RETIRED: List[torch.Tensor] = []


def retire(*tensors) -> None:
    """Keep a replaced workspace allocated for good: a CUDA graph captured
    with it holds its address and writes it at every replay, so freeing it
    would let the allocator hand that memory to another tensor."""
    _RETIRED.extend(t for t in tensors if isinstance(t, torch.Tensor))


class Counter:
    """Launch count of one kernel: each wrapper adds one where it launches
    its kernel and nowhere else. A captured step (``training/graphs.py``)
    credits each counter, at every replay, with the launches its capture
    counted. Every counter made is listed in ``COUNTERS``; a ``tally``
    (which of a kernel's launches took a path inside it) in ``TALLIES``
    instead, so that no sum of launches counts it, and a replay credits
    it all the same."""

    def __init__(self, name: str, *, tally: bool = False):
        self.name = name
        self.launches = 0
        self.tally = tally
        (TALLIES if tally else COUNTERS).append(self)

    def reset(self) -> None:
        self.launches = 0

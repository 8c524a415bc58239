#!/usr/bin/env python3
"""The PyTorch port's (rvt_tpu_torch) kernels on one NVIDIA GPU.

    python3 chip_smoke.py

Times the port's hand-written kernels on one NVIDIA GPU, each beside its
plain PyTorch version, one library call and the least time the card could
take. The paths are timed and checked by the benchmark
(``benchmark/run.py``); the kernels' correctness on the card at small
shapes is ``tests/test_torch_cuda.py``. Phases, each of which raises (exit
code != 0) when it fails:

  1. report the card (name and power limit, from nvidia-smi);
  2. build the CUDA kernels from rvt_tpu_torch/csrc (one nvcc per source,
     all in parallel), print the build time and each kernel's registers
     and spills;
  3. print the bounds of the composed TPU kernels of PERF.md's kernel
     table (rows 3, 5, 7 and 8: ``stage_bounds``); hold each kernel
     against its plain PyTorch version on the card, at every gen1 RVT-B
     stage shape (T*B = 168 frames, and the raw step's B = 8): ln_rows on
     bf16 rows with their f32 copy (the downsample LN as the paths run
     it) and on f32 rows, printing its lane plan, gemm_bf16 with each
     epilogue at the qkv/proj/fc1/fc2 shapes (each line naming the
     schedule and tile its launcher took), partition_attention in
     window and grid mode, lstm_scan at T = 21 and at T = 1; row 2
     (``fused_stage``: K1-K3 over the B frames, K4 at T = 1) at each
     stage with gen1 RVT-B's weights, h and c against its plain version,
     timed beside its plain version and its bound; and stacked_histogram
     with zero error on gen1 events (8 x 32768 over 240x304), on gen4 events
     retargeted into the 360x640 half grid, on a lane whose events all
     hit one pixel, on a lane with out-of-range and past-counts events,
     on t out of order, 100,000 events in one bin, N = 0, counts = 0 and
     a total that is not a multiple of 16, with its event and device time
     at gen1, gen4 ds2 and the clustered lane beside each bound and its
     launches a call; and nms_keep (NMS's keep mask, the kernel that lets
     the steps be captured) with keep masks identical to its plain
     version's on the eval and raw steps' calls, on 48 dense frames of
     1,680 anchors with 577-676 candidates (class-aware and
     class-agnostic), a chain of 1,024 candidates of depth 1,024, boxes
     exactly at the IoU threshold, and 0 and 1 candidates, timed beside
     its bound; and window_s2d (the eval window's layout: the stored
     uint8 window to the s2d stem's bf16 operand) identical to its plain
     version on the stored window's channel-last view at B = 8, T = 21,
     at B = 1, T = 1, on a contiguous window and at a gen4-like 360x640,
     timed beside its bound; and bn_act (train-mode BatchNorm +
     activation of the neck and head, forward and backward) against its
     plain version on every BaseConv call of gen1 RVT-B's, RVT-S's and
     gen4 RVT-B's neck and head at the train cells' 48 gathered frames
     (their layouts and gradients), the same bits on a second run, each
     call shape timed (device time of a CUDA graph of 10 calls) beside
     its bound, the plain version and the PyTorch autograd chain it
     replaced, with each preset's sum a step. Prints the error beside its
     tolerance and the kernel's, plain version's and one library call's
     times (CUDA events; K4's yardstick cuDNN's ``nn.LSTM``,
     ``nn.LSTMCell`` at T = 1), with the least time the card could take
     (bound), the kernel's TFLOP/s and its share of the bound; for
     ln_rows, train_reduce and stacked_histogram also the device time of
     a CUDA graph of 10 calls (no host time between launches); K4 timed
     as whole ``fused_lstm_scan`` calls (the input product, the bf16 cast
     and the recurrent kernel, all counted as K4's launches); then K2
     (every epilogue) and K6 at ragged shapes (M in 1, 127, 129, 1000,
     17000; K, N in 8, 40, 48), K3 and K4 at the other presets'
     geometries (partitions (8, 10), (6, 10), (2, 3), dh 24, 32, 64; C
     48, 96, 512 at T = 21 and 1, ragged rows), and the training kernels
     the small presets reach (K5 at C 48-384, K7 at dh 24 and 32 on the
     three partitions, K8 at C 48-384, T = 21 and 1), correctness only;
  4. hold each training kernel against its plain version at every gen1
     RVT-B stage shape (T*B = 168 frames), forward and backward: K2's
     train epilogues, K4 with c_seq, K5 ln_rows_bwd, K6 gemm_bf16_wgrad,
     K7 partition_attention_bwd, K8 lstm_scan_bwd and train_reduce (one
     launch each for the LayerScale backward and the qkv-bias sums; its
     in-order sums timed at every shape of partials the step gives it,
     each with its launch plan); K6, K2's gelu-backward column sums and
     the three train_reduce functions bit for bit across two runs; time
     each (kernel, plain, library yardstick: K7's SDPA's backward, K8's
     the cuDNN LSTM's backward) beside its bound and its calls per train
     step, K8 as the whole composition its counter counts (pack, the
     gates' and dx's K2 products, the reverse scan); then row 7
     (``fused_stage_step_train``, forward and backward) per call at each
     stage with gen1 RVT-B's weights, against its plain version;
  5. count each kernel's launches in one eager call each of the eval, raw
     and train steps at the benchmark cells' shapes (gen1 RVT-B, bf16, B
     = 8, T = 21) and in one forward and backward of the per-step train
     backbone over that window (counts only, no timing and no check of
     the outputs); fail where the calls a kernel was timed at for one of
     those paths differ from the launches it made, or where a kernel
     launched on the eval, raw or train step was not timed for it (on
     the per-step window only row 7's calls are timed); print the share
     of K2's launches (K4's and K8's products included) that took the
     ping-pong schedule in each, and fail where none of the eval or the
     train step's did; print one line per K4 and per K8 call shape (path, stage, launches, ms beside
     cuDNN's LSTM forward or backward, and the launch plan of the
     recurrent kernel), then the kernels line (per kernel: launches by
     path, and ms, plain, bound and library summed over one step of each
     path it serves, and by path).

It imports nothing of JAX. It exits 2 without a CUDA device or without
the rvt_tpu_torch package beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
BATCH, SEQ_LEN, LABEL_EVERY = 8, 21, 5
EVENTS = 32768
STAGES = ((64, 80, 64), (32, 40, 128), (16, 20, 256), (8, 10, 512))
PART, DIM_HEAD = (8, 10), 32
CARD = ""  # nvidia-smi's name and power limit, set by main


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def time_ms(fn, iters: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Record:
    """One kernel's entry of the kernels line. For each path it serves
    (eval step, raw step, train step; row 7 the per-step train backbone's
    window) it sums count x per-launch time over
    one step's calls; ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` add the paths, ``by_path`` keeps them apart.
    ``device_ms`` (ln_rows and train_reduce; None for the others) is the
    same sum of ``device_ms_of`` times: no host time between launches."""

    def __init__(self, name, source, replaces):
        self.d = dict(name=name, route="cuda", source=source,
                      replaces=replaces, launches=0, max_abs_err=0.0,
                      ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None,
                      library_ms=None, device_ms=None, by_path={})
        self.paths = {}

    def add(self, path, count, err, ms, plain_ms, nbytes, ops, peak, lib_ms,
            launches_per_call=1, device_ms=None):
        """``count`` calls per ``path`` step of a function timed at ``ms``
        per call, which launches the kernel ``launches_per_call`` times.
        ``path`` may be a dict {path: calls per step}, each multiplied by
        ``count``."""
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], err)
        b_ms, o_ms = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        dev = ("" if device_ms is None else f" (device {device_ms:.4f} ms, "
               f"{max(b_ms, o_ms) / device_ms:.1%} of the bound)")
        counts = {p: n * count for p, n in (
            path.items() if isinstance(path, dict) else ((path, 1),)) if n}
        log(f"    per call: kernel {ms:.4f} ms{dev}, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {max(b_ms, o_ms):.4f} ms "
            f"({'bytes' if b_ms >= o_ms else 'operations'}); kernel "
            f"{ops / ms * 1e-9:.1f} TFLOP/s, {max(b_ms, o_ms) / ms:.1%} of "
            "the bound; "
            + ", ".join(f"{n} per {p}" for p, n in counts.items()))
        for path, count in counts.items():
            if count:
                self._accumulate(path, count, ms, plain_ms, b_ms, o_ms,
                                 lib_ms, launches_per_call, device_ms)

    def _accumulate(self, path, count, ms, plain_ms, b_ms, o_ms, lib_ms,
                    launches_per_call, device_ms):
        d = self.d
        q = self.paths.setdefault(path, dict(
            launches=0, ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
            library_ms=None, device_ms=None))
        q["launches"] += count * launches_per_call
        q["ms"] += count * ms
        q["plain_ms"] += count * plain_ms
        q["bytes_ms"] += count * b_ms
        q["ops_ms"] += count * o_ms
        if lib_ms is not None:
            q["library_ms"] = (q["library_ms"] or 0.0) + count * lib_ms
        if device_ms is not None:
            q["device_ms"] = (q["device_ms"] or 0.0) + count * device_ms
        qs = self.paths.values()
        for k in ("ms", "plain_ms"):
            d[k] = sum(q[k] for q in qs)
        devs = [q["device_ms"] for q in qs if q["device_ms"] is not None]
        d["device_ms"] = sum(devs) if devs else None
        d["bound_ms"] = sum(max(q["bytes_ms"], q["ops_ms"]) for q in qs)
        d["bound_by"] = ("bytes" if sum(q["bytes_ms"] for q in qs)
                         >= sum(q["ops_ms"] for q in qs) else "operations")
        libs = [q["library_ms"] for q in qs if q["library_ms"] is not None]
        d["library_ms"] = sum(libs) if libs else None
        d["by_path"] = {p: dict(launches=q["launches"], ms=q["ms"],
                                plain_ms=q["plain_ms"],
                                bound_ms=max(q["bytes_ms"], q["ops_ms"]),
                                library_ms=q["library_ms"],
                                device_ms=q["device_ms"])
                        for p, q in self.paths.items()}


def device_ms_of(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the replay timed with CUDA events. ``time_ms`` times calls
    launched from the host one after another, so where a call's host work
    (the Python wrapper, the launch) outlasts its kernel it measures the
    host's pace; here no host time lies between the launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def compare(name, got, ref, atol, rtol, mean_tol=1e-3):
    """Elementwise |got - ref| <= atol + rtol*|ref| and mean |got - ref| <=
    mean_tol; returns the max abs err. The kernels and the plain versions
    sum in other orders, so a bf16 rounding may land one ulp apart: one
    ulp is 2^-5 = 0.031 for |x| in [4, 8)."""
    import torch

    g, r = got.float(), ref.float()
    err = (g - r).abs()
    bad = err > atol + rtol * r.abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    log(f"  {name}: max|err| {max_err:.3e} mean|err| {mean_err:.3e} "
        f"(tolerance {atol:g} + {rtol:g}*|ref|, mean {mean_tol:g})")
    if (not bool(torch.isfinite(g).all()) or bool(bad.any())
            or mean_err > mean_tol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"({int(bad.sum())} elements out of tolerance)")
    return max_err


LSTM_LIB = {}  # the dtype the cuDNN LSTM yardstick ran in, by call
PINGPONG_SHARE = {}  # K2's launches on the ping-pong schedule, by path
K4_STAGES = []  # (path, stage, T, rows, launches, K4 ms, library ms)
K8_STAGES = []  # the same for K8 (cuDNN's backward), + ms by launch


def log_lstm_stages():
    """K4 and K8 per call at each stage beside their library yardstick
    (cuDNN's fp16 ``nn.LSTM`` forward or backward; ``nn.LSTMCell`` at
    T = 1 serving), same run, with each call's launch plan."""
    from rvt_tpu_torch.ops.fused_scan import lstm_scan_bwd_plan, lstm_scan_plan

    for name, stages, plan in (("K4", K4_STAGES, lstm_scan_plan),
                               ("K8", K8_STAGES, lstm_scan_bwd_plan)):
        for path, stage, T, rows, n, ms, lms, *parts in stages:
            C = int(stage.split("x")[-1])
            by = ("; by launch " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in parts[0].items())
                if parts and parts[0] else "")
            log(f"{name} {path} {stage} T={T}: {n} launches, kernel "
                f"{ms:.4f} ms, library {lms:.4f} ms, factor "
                f"{ms / lms:.2f}; plan {plan(T, rows, C)}{by}")


def k8_parts_ms(x, w, bias, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT):
    """K8's launches one by one, ms each, on the buffers of one
    ``lstm_scan_bwd_launch``: the pack of xh, the gates' K2 product, the
    reverse scan (the cell at T = 1) and the K2 product for dx (dx and
    dh_0 at T = 1). None where the steps run in chunks."""
    import torch

    from rvt_tpu_torch.ops import fused_scan as fs
    from rvt_tpu_torch.ops.fused_attention import gemm_bf16
    from rvt_tpu_torch.ops.kernels import lib, ptr, stream_ptr

    T, B, H, W, C = x.shape
    P = B * H * W
    if fs.lstm_scan_bwd_part_rows(T, P, C) != -(-P // fs._PT):
        return None
    _, dmix, xh, part, _, _ = fs.lstm_scan_bwd_launch(
        x, w, bias, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT)
    mix = gemm_bf16(xh, w, "bias", bias=bias, counter=fs.LSTM_SCAN_BWD)
    dh_out, dc_out = torch.empty_like(h0), torch.empty_like(c0)
    L, st, prod = lib("lstm_scan_bwd"), stream_ptr(x), int(T > 1)

    def run(err):
        if err != 0:
            fail(f"lstm_scan_bwd launch failed: error {err}")

    return {
        "pack": time_ms(lambda: run(L.rvt_lstm_bwd_pack(
            ptr(x), int(x.dtype == torch.float32), ptr(h_seq), ptr(h0),
            ptr(xh), T, P, C, st))),
        "gates": time_ms(lambda: gemm_bf16(xh, w, "bias", bias=bias,
                                           counter=fs.LSTM_SCAN_BWD)),
        "scan" if prod else "cell": time_ms(lambda: run(
            L.rvt_lstm_bwd_scan(
                ptr(mix), ptr(w), ptr(c_seq), ptr(c0), ptr(dh_seq),
                ptr(dhT), ptr(dcT), ptr(dmix), ptr(part),
                ptr(dh_out) if prod else None, ptr(dc_out), 0, T, P, C,
                prod, st))),
        "dx": time_ms(lambda: gemm_bf16(dmix, w[:C] if prod else w,
                                        "rt_f32", counter=fs.LSTM_SCAN_BWD)),
    }


def lstm_library_ms(T, P, C, g, *, grad=False, backward=False):
    """The library yardstick of K4 and K8: the 1x1 ConvLSTM cell over P
    pixels and T steps is an LSTM over P independent sequences with input
    and hidden width C (only the gate order and the bf16 rounding points
    differ). Times ``nn.LSTM`` (cuDNN) forward, under no_grad unless
    ``grad`` (the train forward, which keeps what its backward needs);
    ``nn.LSTMCell`` for the T = 1 serving step; with ``backward`` the
    LSTM's backward to the inputs, initial state and weights, as K8 + K6
    give them. bf16 where cuDNN takes it, else fp16 (``LSTM_LIB``). Timed
    only: nothing in the port calls these."""
    import torch

    dev = torch.device("cuda")
    x16 = torch.empty(1, device=dev, dtype=torch.bfloat16)
    dt = (torch.bfloat16 if torch.backends.cudnn.is_acceptable(x16)
          else torch.float16)
    cell = T == 1 and not (grad or backward)
    what = ("nn.LSTMCell" if cell else "cuDNN nn.LSTM"
            + (" backward" if backward else " forward"))
    LSTM_LIB[what] = str(dt)[6:]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    mod = (torch.nn.LSTMCell(C, C) if cell else torch.nn.LSTM(C, C)).to(
        dev, dt)
    x = randn(T, P, C)
    h0, c0 = (randn(P, C), randn(P, C)) if cell else (randn(1, P, C),
                                                      randn(1, P, C))
    if cell:
        with torch.no_grad():
            return time_ms(lambda: mod(x[0], (h0, c0)))
    if not (grad or backward):
        with torch.no_grad():
            return time_ms(lambda: mod(x, (h0, c0)))
    leaves = [t.requires_grad_(True) for t in (x, h0, c0)]
    if grad:
        return time_ms(lambda: mod(x, (h0, c0)))
    y, (hT, cT) = mod(x, (h0, c0))
    cot = (randn(*y.shape), randn(*hT.shape), randn(*cT.shape))
    leaves += list(mod.parameters())
    return time_ms(lambda: torch.autograd.grad((y, hT, cT), leaves, cot,
                                               retain_graph=True))


def ln_rows_case(fa, randn, s, b, M, C, dtype):
    """K1 on M x C rows as the paths call it: the downsample LN reads the
    bf16 conv output and also writes its f32 copy (the residual stream R,
    ``with_f32``), LN1/LN2 read the f32 residual. Held against the plain
    version (and ``yf`` against ``y`` widened) and timed. Returns (err,
    ms, plain ms, library ms, bytes: x read, y (and yf) written, s and b
    read, device ms)."""
    import torch
    import torch.nn.functional as F

    x = randn(M, C, scale=2.0, dtype=dtype) + 0.5
    with_f32 = dtype == torch.bfloat16
    plan = fa.ln_rows_plan(C, x.element_size())
    log(f"  K1 plan, {str(dtype)[6:]} rows of {C}: {plan.vec} elements a "
        f"load, {plan.nv} loads a lane, {32 // plan.group} rows a warp")
    got = fa.ln_rows(x, s, b, 1e-5, with_f32=with_f32)
    y = got[0] if with_f32 else got
    if with_f32 and not torch.equal(got[1], y.float()):
        fail("ln_rows: yf is not y widened to f32")
    err = compare(f"ln_rows[{str(dtype)[6:]}{' + yf' if with_f32 else ''}]",
                  y, fa.ln_rows_plain(x, s, b, 1e-5), 3.2e-2, 1e-2)
    del got, y
    ms = time_ms(lambda: fa.ln_rows(x, s, b, 1e-5, with_f32=with_f32))
    dms = device_ms_of(lambda: fa.ln_rows(x, s, b, 1e-5, with_f32=with_f32))
    pms = time_ms(lambda: fa.ln_rows(x, s, b, 1e-5, with_f32=with_f32,
                                     plain=True))
    sw, bw = s.to(dtype), b.to(dtype)
    lms = time_ms(lambda: F.layer_norm(x, (C,), sw, bw, 1e-5))
    nbytes = M * C * (x.element_size() + 2 + (4 if with_f32 else 0)) + 4 * C
    return err, ms, pms, lms, nbytes, dms


def k2_schedule(M, N, K, epi):
    """The schedule K2's launcher takes for ``epi`` at (M, N, K), as a
    label; fails where ``gemm_schedule`` (the Python mirror that the
    schedule tallies count by) disagrees."""
    import torch

    from rvt_tpu_torch.ops import fused_attention as fa

    plan = fa.gemm_plan(M, N, K, epi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if plan != fa.gemm_schedule(M, N, K, epi, sms):
        fail(f"gemm_bf16 {epi} at M={M}, N={N}, K={K}: the launcher takes "
             f"{plan}, gemm_schedule says otherwise")
    return (f"{'ping-pong' if plan.pingpong else 'cooperative'} "
            f"{plan.rows}x{plan.cols}")


def check_pair_kernels(recs, randn, g, H, W, C, n_frames, per):
    """Phase 3: K1-K3 at one stage over ``n_frames`` frames, against their
    plain versions, timed; ``per(eval calls, train calls)`` gives the calls
    per step of each path that runs them at these shapes."""
    import torch
    import torch.nn.functional as F

    from rvt_tpu_torch.ops import fused_attention as fa

    dev = g.device
    M = n_frames * H * W
    log(f"stage {H}x{W}x{C}: {n_frames} frames, {M} rows")
    s, b = randn(C, scale=0.2) + 1.0, randn(C, scale=0.2)
    # K1: the ds-LN reads the bf16 conv output, LN1/LN2 the f32 residual;
    # the train step runs each twice (forward, recompute)
    for dtype, count in ((torch.bfloat16, 1), (torch.float32, 3)):
        err, ms, pms, lms, nbytes, dms = ln_rows_case(fa, randn, s, b, M,
                                                      C, dtype)
        recs["ln_rows"].add(per(count, 2 * count), 1, err, ms, pms, nbytes,
                            8 * M * C, PEAK_F32_FLOPS, lms, device_ms=dms)
    # K2: every product of the two sub-blocks
    for label, K, N, epi in (("qkv", C, 3 * C, "bias"),
                             ("proj", C, C, "residual"),
                             ("fc1", C, 4 * C, "gelu"),
                             ("fc2", 4 * C, C, "residual")):
        a = randn(M, K)
        w = randn(K, N, scale=K ** -0.5)
        bias = randn(N, scale=0.1)
        R0 = randn(M, N, dtype=torch.float32) if epi == "residual" else None
        got = fa.gemm_bf16(a, w, epi, bias=bias,
                           out=R0.clone() if R0 is not None else None)
        ref = fa.gemm_bf16(a, w, epi, bias=bias, plain=True,
                           out=R0.clone() if R0 is not None else None)
        err = compare(f"gemm_bf16[{label} {epi}, "
                      f"{k2_schedule(M, N, K, epi)}]", got, ref, 3.2e-2,
                      1e-2)
        R1 = R0.clone() if R0 is not None else None
        ms = time_ms(lambda: fa.gemm_bf16(a, w, epi, bias=bias, out=R1))
        pms = time_ms(lambda: fa.gemm_bf16(a, w, epi, bias=bias, out=R1,
                                           plain=True))
        lms = time_ms(lambda: torch.matmul(a, w))
        out_bytes = M * N * (8 if epi == "residual" else 2)
        recs["gemm_bf16"].add(per(2, 0), 1, err, ms, pms,
                              2 * (M * K + K * N + N) + out_bytes,
                              2 * M * N * K, PEAK_BF16_FLOPS, lms)
    # K3: window and grid attention
    heads = C // DIM_HEAD
    n_tok = PART[0] * PART[1]
    parts = (H // PART[0]) * (W // PART[1])
    qkv = randn(n_frames, H, W, 3 * C)
    for window in (True, False):
        kw = dict(heads=heads, dim_head=DIM_HEAD, part=PART, window=window)
        got = fa.partition_attention(qkv, **kw)
        ref = fa.partition_attention_plain(qkv, heads, DIM_HEAD, PART,
                                           window)
        mode = "window" if window else "grid"
        err = compare(f"partition_attention[{mode}]", got, ref, 3.2e-2,
                      1e-2)
        ms = time_ms(lambda: fa.partition_attention(qkv, **kw))
        pms = time_ms(lambda: fa.partition_attention_plain(
            qkv, heads, DIM_HEAD, PART, window))
        q, k, v = [torch.randn(n_frames * parts, heads, n_tok, DIM_HEAD,
                               generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3)]
        lms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        # the train step: the forward and the backward's recompute
        recs["partition_attention"].add(
            per(1, 2), 1, err, ms, pms, M * 4 * C * 2,
            4 * n_frames * parts * heads * n_tok * n_tok * DIM_HEAD,
            PEAK_BF16_FLOPS, lms)


def check_kernels():
    """Phase 3, at the main path's shapes (T*B frames through the pair,
    B lanes through the scan) and the raw step's (B frames through the
    pair, B lanes at T = 1). Returns {kernel name: Record}."""
    import torch

    from rvt_tpu_torch.ops import fused_scan as fs

    recs = {
        "ln_rows": Record("ln_rows", "rvt_tpu_torch/csrc/ln_rows.cu",
                          "rvt_tpu/ops/fused_attention.py:126"),
        "gemm_bf16": Record("gemm_bf16", "rvt_tpu_torch/csrc/gemm_bf16.cu",
                            "rvt_tpu/ops/fused_attention.py:155"),
        "partition_attention": Record(
            "partition_attention",
            "rvt_tpu_torch/csrc/partition_attention.cu",
            "rvt_tpu/ops/fused_attention.py:155"),
        "lstm_scan": Record("lstm_scan", "rvt_tpu_torch/csrc/lstm_scan.cu",
                            "rvt_tpu/ops/fused_scan.py:228"),
    }
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    T, B = SEQ_LEN, BATCH
    for H, W, C in STAGES:
        # K1-K3 over the T*B frames of a window (the eval and train steps)
        # and over the B frames of a raw step
        check_pair_kernels(recs, randn, g, H, W, C, T * B, lambda e, t: {
            "eval step": e, "train step": t})
        check_pair_kernels(recs, randn, g, H, W, C, B,
                           lambda e, t: {"raw step": e})
        # K4: the window scan on the f32 residual (main path) and T = 1
        # (the raw step), with the weights as the serving step keeps them
        # and, wider than 64 channels, the residual's bf16 copy that the
        # pair's last product writes; timed as whole calls (the input
        # product and the scan)
        w = randn(2 * C, 4 * C, scale=(2 * C) ** -0.5)
        wt = fs.lstm_weights_t(w)
        bias = randn(4 * C, scale=0.1)
        h0 = randn(B, H, W, C, scale=0.5, dtype=torch.float32)
        c0 = randn(B, H, W, C, scale=0.5, dtype=torch.float32)
        for steps, path in ((T, "eval step"), (1, "raw step")):
            x = randn(steps, B, H, W, C, dtype=torch.float32)
            xb = x.to(torch.bfloat16) if C > 64 else None
            got = fs.fused_lstm_scan(x, w, bias, h0, c0, lstm_wt=wt,
                                     x_bf16=xb)
            ref = fs.lstm_scan_plain(x, w, bias, h0, c0)
            err = 0.0
            for nm, gt, rf, tol in (("h_seq", got[0], ref[0], 2e-2),
                                    ("h_T", got[1], ref[1], 2e-2),
                                    ("c_T", got[2], ref[2], 5e-2)):
                err = max(err, compare(f"lstm_scan[T={steps}] {nm}", gt, rf,
                                       tol, 2e-2, 2e-3))
            if steps == 1:
                hT, cT = fs.fused_conv_lstm(x[0], h0, c0, w, bias)
                err = max(err, compare("fused_conv_lstm h", hT, ref[1],
                                       2e-2, 2e-2))
            ms = time_ms(lambda: fs.fused_lstm_scan(x, w, bias, h0, c0,
                                                    lstm_wt=wt, x_bf16=xb))
            pms = time_ms(lambda: fs.lstm_scan_plain(x, w, bias, h0, c0), 2)
            P = B * H * W
            lms = lstm_library_ms(steps, P, C, g)
            x_bytes = 4 if xb is None else 2  # what K4 reads of x
            nbytes = (steps * P * C * (x_bytes + 2)
                      + 2 * (8 * C * C + 4 * C) + 4 * P * C * 4)
            launches = fs.lstm_scan_launches(steps, P, C)
            recs["lstm_scan"].add(path, 1, err, ms, pms, nbytes,
                                  2 * steps * P * 2 * C * 4 * C,
                                  PEAK_BF16_FLOPS, lms,
                                  launches_per_call=launches)
            K4_STAGES.append((path, f"{H}x{W}x{C}", steps, P, launches,
                              ms, lms))
        torch.cuda.empty_cache()
    return recs


def check_gemm_edges():
    """Phase 3, correctness only: K2 (every epilogue) and K6 at ragged
    shapes, M in (1, 127, 129, 1000, 17000: each of K2's three row tilings)
    against K and N in (8, 40, 48) (TMA's zero fill past the arrays, the
    masked stores), held against their
    plain versions at phase 3's and phase 4's tolerances; K6 and the gelu
    backward's column sums bit for bit across two runs."""
    import torch

    from rvt_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    f32 = torch.float32

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    n = 0
    for M in (1, 127, 129, 1000, 17000):
        for K, N in ((8, 40), (40, 48), (48, 8), (40, 40)):
            for epi in fa.EPILOGUES:
                rt = epi.startswith("rt_")
                a = randn(M, K)
                w = randn(*((N, K) if rt else (K, N)), scale=K ** -0.5)
                kw = {} if rt else {"bias": randn(N, scale=0.1)}
                if epi == "residual_ls":
                    kw.update(gamma=randn(N, scale=0.3, dtype=f32),
                              res_in=randn(M, N, dtype=f32))
                if epi == "rt_gelu_bwd":
                    kw["aux"] = randn(M, N)
                R = (randn(M, N, dtype=f32) if epi in ("residual", "rt_acc")
                     else None)
                want = epi in ("gelu", "residual_ls")

                def run(plain):
                    return fa.gemm_bf16(a, w, epi, want_aux=want, plain=plain,
                                        out=None if R is None else R.clone(),
                                        **kw)

                got, ref = run(False), run(True)
                g0 = got[0] if isinstance(got, tuple) else got
                r0 = ref[0] if isinstance(ref, tuple) else ref
                bad = ((g0.float() - r0.float()).abs()
                       > 3.2e-2 + 1e-2 * r0.float().abs())
                if not bool(torch.isfinite(g0.float()).all()) or bool(
                        bad.any()):
                    fail(f"gemm_bf16[{epi}] at M={M}, K={K}, N={N} disagrees "
                         "with its plain version")
                if epi == "rt_gelu_bwd":
                    if compare_rel_quiet(got[1], ref[1]) > 1e-3:
                        fail(f"gemm_bf16[rt_gelu_bwd] column sums at M={M}, "
                             f"K={K}, N={N} disagree")
                    again = run(False)
                    if not (torch.equal(got[0], again[0])
                            and torch.equal(got[1], again[1])):
                        fail("gemm_bf16 rt_gelu_bwd: two runs differ")
                n += 1
            a, b = randn(M, K), randn(M, N)
            got = fa.gemm_bf16_wgrad(a, b)
            if compare_rel_quiet(got, fa.gemm_bf16_wgrad_plain(a, b)) > 1e-3:
                fail(f"gemm_bf16_wgrad at M={M}, Ka={K}, Nb={N} disagrees")
            if not torch.equal(got, fa.gemm_bf16_wgrad(a, b)):
                fail("gemm_bf16_wgrad: two runs differ")
            n += 1
    log(f"ragged shapes: {n} products of K2 (every epilogue) and K6 agree "
        "with their plain versions (tolerance 0.032 + 0.01*|ref|; sums "
        "1e-3 of max|ref|); K6 and the gelu backward's sums bit for bit "
        "across two runs")


def check_attention_lstm_edges():
    """Phase 3, correctness only: K3 and K4 at the geometries of the other
    presets, against their plain versions at phase 3's tolerances. K3 at
    partitions (8, 10), gen4's (6, 10) (60 tokens) and (2, 3), dh 24, 32
    and 64, window and grid; K4 at C = 48, 96 and 512, T = 21 and 1, x f32
    and bf16, 391 pixels a lane (rows not a multiple of the 16-row tile
    nor of the cluster's row tile)."""
    import torch

    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    n = 0
    for part, (H, W) in (((8, 10), (16, 20)), ((6, 10), (12, 20)),
                         ((2, 3), (12, 12))):
        for dh in (24, 32, 64):
            for heads in (2, 16):
                C = heads * dh
                qkv = randn(6, H, W, 3 * C)
                for window in (True, False):
                    got = fa.partition_attention(qkv, heads=heads,
                                                 dim_head=dh, part=part,
                                                 window=window)
                    ref = fa.partition_attention_plain(qkv, heads, dh, part,
                                                       window)
                    bad = ((got.float() - ref.float()).abs()
                           > 3.2e-2 + 1e-2 * ref.float().abs())
                    if bool(bad.any()) or not bool(
                            torch.isfinite(got.float()).all()):
                        fail(f"partition_attention at part {part}, dh {dh}, "
                             f"C {C}, window {window} disagrees with its "
                             "plain version")
                    n += 1
    log(f"partition geometries: {n} cases of K3 agree with its plain "
        "version (tolerance 0.032 + 0.01*|ref|)")
    n = 0
    for C in (48, 96, 512):
        w = randn(2 * C, 4 * C, scale=(2 * C) ** -0.5)
        bias = randn(4 * C, scale=0.1)
        B, H, W = 2, 17, 23
        h0 = randn(B, H, W, C, scale=0.5, dtype=torch.float32)
        c0 = randn(B, H, W, C, scale=0.5, dtype=torch.float32)
        for T in (SEQ_LEN, 1):
            for dtype in (torch.float32, torch.bfloat16):
                x = randn(T, B, H, W, C, dtype=dtype)
                got = fs.fused_lstm_scan(x, w, bias, h0, c0,
                                         with_c_seq=True)
                ref = fs.lstm_scan_plain(x, w, bias, h0, c0, True)
                for nm, gt, rf, tol in zip(("h_seq", "c_seq", "h_T", "c_T"),
                                           got, ref,
                                           (2e-2, 5e-2, 2e-2, 5e-2)):
                    compare(f"lstm_scan C={C} T={T} {str(dtype)[6:]} {nm}",
                            gt, rf, tol, 2e-2, 2e-3)
                n += 1
    log(f"LSTM widths: {n} cases of K4 agree with its plain version")
    check_small_preset_train_kernels(randn)


def check_small_preset_train_kernels(randn):
    """Phase 3, correctness only: the training kernels the small presets
    (RVT-S: C 48, 96, 192, 384, dh 24) and gen4's (6, 10) partition reach,
    against their plain versions at phase 4's tolerances: K5 at C 48-384
    (f32 rows added into dres, bf16 rows to bf16); K7 at dh 24 and 32 on
    (8, 10), (6, 10) and (2, 3), window and grid; K8 at C 48-384, T = 21
    and 1, x f32 and bf16, 391 pixels a lane."""
    import torch

    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.ops import fused_scan as fs

    f32 = torch.float32
    n = 0
    for C in (48, 96, 192, 384):
        s = randn(C, scale=0.2) + 1.0
        for xdt, add in ((f32, True), (torch.bfloat16, False)):
            x = randn(3000, C, scale=2.0, dtype=xdt) + 0.5
            dy = randn(3000, C, dtype=f32)
            d0 = randn(3000, C, dtype=f32) if add else None
            got = fa.ln_rows_bwd(x, dy, s, 1e-5,
                                 dres=None if d0 is None else d0.clone())
            ref = fa.ln_rows_bwd(x, dy, s, 1e-5, plain=True,
                                 dres=None if d0 is None else d0.clone())
            compare(f"ln_rows_bwd C={C} {str(xdt)[6:]} dx", got[0], ref[0],
                    1e-3 if add else 3.2e-2, 1e-2)
            compare_rel("  ds", got[1], ref[1], 1e-3)
            compare_rel("  db", got[2], ref[2], 1e-3)
            n += 1
    log(f"small-preset widths: {n} cases of K5 agree with its plain version")
    n = 0
    for part, (H, W) in (((8, 10), (16, 20)), ((6, 10), (12, 20)),
                         ((2, 3), (12, 12))):
        for dh, heads in ((24, 2), (24, 16), (32, 4)):
            C = heads * dh
            qkv, do = randn(6, H, W, 3 * C), randn(6, H, W, C)
            for window in (True, False):
                kw = dict(heads=heads, dim_head=dh, part=part, window=window)
                compare(f"partition_attention_bwd part {part} dh {dh} C {C} "
                        f"{'window' if window else 'grid'}",
                        fa.partition_attention_bwd(qkv, do, **kw),
                        fa.partition_attention_bwd(qkv, do, plain=True,
                                                   **kw), 3.2e-2, 2e-2)
                n += 1
    log(f"small-preset geometries: {n} cases of K7 agree with its plain "
        "version")
    n = 0
    B, H, W = 2, 17, 23
    for C in (48, 96, 192, 384):
        w = randn(2 * C, 4 * C, scale=(2 * C) ** -0.5)
        bias = randn(4 * C, scale=0.1)
        h0 = randn(B, H, W, C, scale=0.5, dtype=f32)
        c0 = randn(B, H, W, C, scale=0.5, dtype=f32)
        dhT, dcT = randn(B, H, W, C, dtype=f32), randn(B, H, W, C, dtype=f32)
        for T in (SEQ_LEN, 1):
            for dtype in (f32, torch.bfloat16):
                x = randn(T, B, H, W, C, dtype=dtype)
                h_seq, c_seq, _, _ = fs.lstm_scan_plain(x, w, bias, h0, c0,
                                                        True)
                args = (x, w, bias, h0, c0, h_seq, c_seq,
                        randn(T, B, H, W, C, scale=0.5), dhT, dcT)
                for nm, gt, rf in zip(("dx", "dW", "db", "dh0", "dc0"),
                                      fs.lstm_scan_bwd(*args),
                                      fs.lstm_scan_bwd(*args, plain=True)):
                    compare_rel(f"lstm_scan_bwd C={C} T={T} {str(dtype)[6:]} "
                                f"{nm}", gt, rf, 2e-2)
                n += 1
    log(f"small-preset widths: {n} cases of K8 agree with its plain version")


def check_voxelizer():
    """Phase 3, the voxelizer: stacked_histogram against its plain version
    with zero error on gen1 events, gen4 events retargeted into the ds2
    half grid (and against full resolution + 1::2), a clustered lane, out
    of range events, bin edges, t out of order, more than 65,535 events
    in one bin, N = 0, counts = 0, counts > N and a total that is not a
    multiple of 16. Times the gen1 raw shape, gen4 ds2 and the clustered
    lane (event time, and the device time of a CUDA graph of 10 calls)
    beside each bound; prints the kernel launches a call. Returns its
    Record (timed at the raw path's gen1 shape, one wrapper call per raw
    step)."""
    import torch

    from rvt_tpu_torch.inference import ds2_retarget
    from rvt_tpu_torch.ops import voxelization as vx

    rec = Record("stacked_histogram",
                 "rvt_tpu_torch/csrc/stacked_histogram.cu",
                 "rvt_tpu/ops/voxelization.py:127")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    B, N, bins = BATCH, EVENTS, 10

    def events(H, W, n=N, lanes=B):
        def ints(hi):
            return torch.randint(0, hi, (lanes, n), generator=g, device=dev,
                                 dtype=torch.int32)
        t = torch.sort(ints(50_000), dim=1).values
        counts = torch.full((lanes,), max(n - 17, 0), dtype=torch.int32,
                            device=dev)
        return [ints(W), ints(H), ints(2), t, counts]

    def check(label, ev, H, W):
        n = vx.STACKED_HISTOGRAM.launches
        got = vx.stacked_histogram_batched(*ev, bins, H, W)
        if vx.STACKED_HISTOGRAM.launches != n + 1:
            fail("stacked_histogram: the wrapper did not count its call")
        ref = vx.stacked_histogram_plain(*ev, bins, H, W)
        err = float((got.int() - ref.int()).abs().max()) if ref.numel() else 0.0
        log(f"  stacked_histogram[{label}]: max|err| {err:g} (tolerance 0: "
            f"integer counts), {int(ref.sum())} events counted, "
            f"max count {int(ref.max()) if ref.numel() else 0}")
        if not torch.equal(got, ref):
            fail(f"stacked_histogram[{label}] differs from its plain version")
        return got, err

    def timed(label, ev, H, W):
        """Event and device time beside the bound: each kept event's x,
        y, p, t read once, counts read, uint8 out; ~10 operations per
        event for its bin, one per output bin to narrow."""
        lanes, n = ev[0].shape
        plan = vx.histogram_plan(lanes, n, bins, H, W)
        plane = 2 * bins * H * W
        fn = lambda: vx.stacked_histogram_batched(*ev, bins, H, W)  # noqa
        ms, dms = time_ms(fn, 20), device_ms_of(fn)
        n_valid = int(torch.clamp(ev[4], 0, n).sum())
        nbytes = 16 * n_valid + 4 * lanes + lanes * plane
        ops = 10 * n_valid + lanes * plane
        bound = max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS) * 1e3
        log(f"  stacked_histogram time[{label}]: event {ms:.4f} ms, device "
            f"{dms:.4f} ms, bound {bound:.4f} ms ({bound / dms:.1%} of it "
            f"by device time, {bound / ms:.1%} by event time); "
            f"{plan.launches} kernel launches a call (bucket, "
            f"tile), {plan.tiles} tiles of {plan.tile_bins} bins; "
            f"{CARD}")
        return ms, dms, nbytes, ops, n_valid

    log(f"voxelizer: {B} lanes x {N} events")
    ev = events(240, 304)
    _, err = check("gen1 240x304", ev, 240, 304)
    # gen4: full-sensor events, the ds2-direct retarget into 360x640, also
    # held against voxelizing 720x1280 and taking every odd pixel
    ev4 = events(720, 1280)
    x2, y2 = ds2_retarget(ev4[0], ev4[1], bins, 360, 640)
    ev4d = [x2, y2] + ev4[2:]
    half, e = check("gen4 ds2 360x640", ev4d, 360, 640)
    err = max(err, e)
    full = vx.stacked_histogram_batched(*ev4, bins, 720, 1280)
    if not torch.equal(half, full[..., 1::2, 1::2]):
        fail("stacked_histogram: ds2-direct differs from full-res + 1::2")
    # lane 0: every event on one pixel (saturation, one contended counter)
    evc = [a.clone() for a in ev]
    evc[0][0], evc[1][0], evc[2][0] = 151, 119, 0
    got, e = check("clustered lane", evc, 240, 304)
    err = max(err, e)
    if int(got[0].max()) != 255:
        fail("stacked_histogram: the clustered pixel did not saturate")
    # lane 1: out-of-range x, y, p and a short valid prefix
    evd = [a.clone() for a in ev]
    evd[0][1, ::5], evd[1][1, 1::5], evd[2][1, 2::5] = 304, -1, 2
    evd[0][1, 3::5] = -7
    evd[4][1] = N // 3
    err = max(err, check("dropped events", evd, 240, 304)[1])
    # every timestamp of spans where an inexact division or a contracted
    # multiply would move events across a bin edge
    spans = torch.tensor([10, 25, 50, 100, 41, 47, 55, 82], device=dev)
    evt = [a.clone() for a in ev]
    evt[3] = (torch.minimum(torch.arange(N, device=dev)[None], spans[:, None])
              + 1000).to(torch.int32)
    evt[4] = (spans + 1).to(torch.int32)
    err = max(err, check("bin edges", evt, 240, 304)[1])
    # t out of order (the bins span t[b, 0] .. t[b, counts - 1]); lane 2
    # counts past N
    evu = [a.clone() for a in ev]
    evu[3] = torch.randint(0, 50_000, (B, N), generator=g, device=dev,
                           dtype=torch.int32)
    evu[4][2] = N + 100
    err = max(err, check("unsorted t, counts > N", evu, 240, 304)[1])
    # 100,000 events in one bin of lane 0: a counter past 65,535
    evh = events(240, 304, 100_000, 2)
    evh[0][0], evh[1][0], evh[2][0], evh[3][0] = 5, 6, 1, 9
    evh[4][0] = 100_000
    got, e = check("100000 events in one bin", evh, 240, 304)
    err = max(err, e)
    if int(got[0].max()) != 255:
        fail("stacked_histogram: the hot bin did not saturate")
    # no events, no valid events, a total that is not a multiple of 16
    e0 = [a[:, :0].contiguous() for a in ev[:4]] + [ev[4]]
    err = max(err, check("N = 0", e0, 240, 304)[1])
    ez = [a.clone() for a in ev]
    ez[4].zero_()
    err = max(err, check("counts = 0", ez, 240, 304)[1])
    err = max(err, check("3 lanes of 7x9: total % 16 = 4",
                         events(7, 9, lanes=3), 7, 9)[1])

    H, W = 240, 304
    plane = 2 * bins * H * W
    ms, dms, nbytes, ops, _ = timed("gen1 raw cell 240x304", ev, H, W)
    timed("gen4 ds2 360x640", ev4d, 360, 640)
    timed("clustered lane", evc, H, W)
    pms = time_ms(lambda: vx.stacked_histogram_plain(*ev, bins, H, W))
    flat = vx.flat_bins(*ev, bins, H, W).reshape(-1)
    lms = time_ms(lambda: torch.bincount(flat, minlength=B * plane + 1), 20)
    log(f"stacked_histogram: {vx.histogram_plan(B, N, bins, H, W).launches}"
        " kernel launches per call (one wrapper call, counted once)")
    rec.add("raw step", 1, err, ms, pms, nbytes, ops, PEAK_F32_FLOPS, lms,
            device_ms=dms)
    return rec


NMS_PAIR_OPS = 20  # f32 operations of one IoU test (nms_keep.cu:iou_xyxy)


def nms_work(keep, valid):
    """(bytes, operations) ``nms_keep`` needs for these inputs: boxes,
    validity and keep once each; 20 f32 operations for each pair the sweep
    tests (each kept box against the valid boxes after it)."""
    import torch

    B, K = valid.shape
    n = valid.sum(-1, keepdim=True)
    idx = torch.arange(K, device=valid.device)[None]
    pairs = torch.where(keep & (idx < n), n - 1 - idx, 0).sum()
    return B * K * (16 + 1 + 1), int(pairs) * NMS_PAIR_OPS


def nms_frames(B, K, n_lo, n_hi, gen, *, classes=2, hw=(240, 304)):
    """B score-sorted frames of K boxes with n_lo..n_hi candidates each:
    random xyxy boxes of 8-64 pixels, offset by class as postprocess
    offsets them (``classes`` 1: class-agnostic)."""
    import torch

    xy = torch.rand(B, K, 2, generator=gen) * torch.tensor(hw[::-1])
    wh = torch.rand(B, K, 2, generator=gen) * 56 + 8
    b = torch.cat([xy, xy + wh], -1)
    cls = torch.randint(0, classes, (B, K, 1), generator=gen).float()
    b = b + cls * (b.amax() + 1.0)
    n = torch.randint(n_lo, n_hi + 1, (B, 1), generator=gen)
    return b.cuda(), (torch.arange(K)[None] < n).cuda()


def check_nms_keep():
    """Phase 3, NMS: ``nms_keep`` against its plain version (the Jacobi
    fixpoint), identical keep masks, on: the eval and raw steps' calls (48
    and 8 frames of pre_nms_topk 512, no candidate at threshold 0.1);
    48 dense frames of gen1's 1,680 anchors with 577-676 candidates,
    class-aware and class-agnostic (the validation loop's load at a low
    confidence threshold); a frame of 1,024 candidates in a
    suppression chain of depth 1,024 (above 512, every other box kept);
    pairs at IoU exactly 1/2 against a threshold of 1/2; 0 and 1
    candidates. Times the steps' calls and the dense frames (CUDA events;
    device time of a CUDA graph of 10 calls) beside the bound and the
    plain version. Returns its Record."""
    import torch

    from rvt_tpu_torch.ops import boxes as bx

    rec = Record("nms_keep", "rvt_tpu_torch/csrc/nms_keep.cu",
                 "rvt_tpu/ops/boxes.py:63 (XLA ops in the jitted step; "
                 "not a TPU kernel)")
    gen = torch.Generator().manual_seed(7)
    x = torch.arange(1024.0) * 3
    chain = torch.stack([x, torch.zeros_like(x), x + 10,
                         torch.full_like(x, 10)], -1)[None]
    pair = torch.tensor([[[0.0, 0, 2, 1], [0, 0, 1, 1], [5, 5, 7, 6],
                          [5, 5, 6, 6.5]]])
    cases = {
        "eval step": nms_frames(BATCH * 6, 512, 0, 0, gen) + (0.45,),
        "raw step": nms_frames(BATCH, 512, 0, 0, gen) + (0.45,),
        "dense": nms_frames(BATCH * 6, 1680, 577, 676, gen) + (0.45,),
        "dense agnostic": nms_frames(BATCH * 6, 1680, 577, 676, gen,
                                     classes=1) + (0.45,),
        "chain": (chain.cuda(), torch.ones(1, 1024, dtype=torch.bool,
                                           device="cuda"), 0.45),
        "at threshold": (pair.cuda(), torch.ones(1, 4, dtype=torch.bool,
                                                 device="cuda"), 0.5),
        "0 and 1 candidates": nms_frames(2, 1680, 0, 0, gen)[:1]
        + (torch.arange(1680, device="cuda")[None] < torch.tensor(
            [[0], [1]], device="cuda"), 0.45),
    }
    for name, (b, v, thr) in cases.items():
        keep = bx.nms_keep(b, v, thr)
        ref = bx.nms_keep_plain(b, v, thr)
        torch.cuda.synchronize()
        if not torch.equal(keep, ref):
            fail(f"nms_keep [{name}]: {int((keep != ref).sum())} keep flags "
                 "differ from the plain version")
        if name == "chain" and not torch.equal(
                keep[0], torch.arange(1024, device="cuda") % 2 == 0):
            fail("nms_keep [chain]: not every other box kept")
        if name == "at threshold" and not bool(keep.all()):
            fail("nms_keep [at threshold]: a box at IoU 1/2 suppressed")
        nbytes, ops = nms_work(ref, v)
        log(f"  nms_keep[{name}]: {tuple(b.shape[:2])} boxes, "
            f"{int(v.sum(-1).min())}-{int(v.sum(-1).max())} candidates, "
            f"{int(ref.sum())} kept, identical to the plain version")
        if name not in ("eval step", "raw step", "dense"):
            continue
        ms = time_ms(lambda: bx.nms_keep(b, v, thr))
        dms = device_ms_of(lambda: bx.nms_keep(b, v, thr))
        pms = time_ms(lambda: bx.nms_keep_plain(b, v, thr))
        if name == "dense":  # the validation loop's load: logged apart
            b_ms, o_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
            by = "bytes" if b_ms >= o_ms else "operations"
            log(f"    per call: kernel {ms:.4f} ms (device {dms:.4f} ms), "
                f"plain {pms:.4f} ms, library none, bound "
                f"{max(b_ms, o_ms):.4f} ms ({by}; {ops // NMS_PAIR_OPS} "
                "pair tests)")
            continue
        rec.add(name, 1, 0.0, ms, pms, nbytes, ops, PEAK_F32_FLOPS, None,
                device_ms=dms)
    return rec


def check_window_s2d():
    """Phase 3, the eval window's layout: ``window_s2d`` against its plain
    version (pad, s2d, T-major, bf16) bit for bit, on the stored window's
    channel-last view at the eval cell's B = 8, T = 21, 240x304x20 ->
    256x320 (bytes 0-255), at B = 1, T = 1, on a contiguous channel-last
    window (the byte path) and at a gen4-like 360x640 -> 384x640, whose
    51.5 KB of staged rows a block need the raised shared-memory limit.
    Times the eval cell's call (CUDA events; device time of a CUDA graph
    of 10 calls) beside its bound (the window read once, the operand
    written once), the plain version and one library call over the same
    bytes (the stored view's uint8 -> bf16 cast). Returns its Record."""
    import torch

    from rvt_tpu_torch.ops import s2d

    rec = Record("window_s2d", "rvt_tpu_torch/csrc/window_s2d.cu",
                 "rvt_tpu/ops/s2d.py:device_space_to_depth (XLA ops and "
                 "the stem conv's cast; not a TPU kernel)")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def stored(b, t, c, hw):
        st = torch.randint(0, 256, (b, t, c) + hw, generator=gen,
                           device="cuda", dtype=torch.uint8)
        return st.permute(0, 1, 3, 4, 2)

    cases = {
        "eval step": (stored(BATCH, SEQ_LEN, 20, (240, 304)), (256, 320)),
        "B 1 T 1": (stored(1, 1, 20, (240, 304)), (256, 320)),
        "contiguous": (stored(2, 3, 20, (240, 304)).contiguous(),
                       (256, 320)),
        "gen4-like": (stored(1, 2, 20, (360, 640)), (384, 640)),
    }
    for name, (ev, target) in cases.items():
        got = s2d.window_s2d(ev, target)
        ref = s2d.window_s2d_plain(ev, target)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"window_s2d [{name}]: {int((got != ref).sum())} elements "
                 "differ from the plain version")
        log(f"  window_s2d[{name}]: {tuple(ev.shape)} strides "
            f"{ev.stride()} -> {tuple(got.shape)} bf16, identical to the "
            "plain version")
        if name != "eval step":
            continue
        nbytes = ev.numel() + got.numel() * got.element_size()
        ms = time_ms(lambda: s2d.window_s2d(ev, target))
        dms = device_ms_of(lambda: s2d.window_s2d(ev, target))
        pms = time_ms(lambda: s2d.window_s2d_plain(ev, target))
        lms = time_ms(lambda: ev.to(torch.bfloat16))
        rec.add(name, 1, 0.0, ms, pms, nbytes, 0, PEAK_BF16_FLOPS, lms,
                device_ms=dms)
        del got, ref
        torch.cuda.empty_cache()
    return rec


def check_bn_act():
    """Phase 3, train-mode BatchNorm + activation (``ops/bn_act.py``):
    every BaseConv call of the neck and head of gen1 RVT-B, RVT-S and gen4
    RVT-B at the train cells' 48 gathered frames (``tests/
    test_torch_cuda.py:bn_act_calls``), forward and backward against the
    plain version (its tolerances) and bit for bit on a second run. Each
    call shape (layout, dtype, activation) timed once: the four launches
    as a CUDA graph of 10 calls (device time) and host-paced, the plain
    version, and the autograd chain of PyTorch ops the port ran before
    (flax's BatchNorm then the activation, forward and backward; device
    time), beside the bound (y and the gradient read once, the
    activation and dy written once). Gen1 RVT-B's calls count for the
    train step path; the others are printed. Returns its Record."""
    from collections import Counter as Tally

    import torch

    from rvt_tpu_torch.ops import bn_act as ba
    from tests.test_torch_cuda import BN_TOL, bn_act_calls, bn_act_vs_plain

    rec = Record("bn_act", "rvt_tpu_torch/csrc/bn_act.cu",
                 "rvt_tpu/models/yolox.py:BaseConv's nn.BatchNorm and "
                 "activation (XLA ops; not a TPU kernel)")

    def chain(y, gr, bn, act, leaves):
        yl, w, b = leaves
        yf = yl.float()
        mean, msq = yf.mean((0, 2, 3)), (yf * yf).mean((0, 2, 3))
        var = torch.clamp(msq - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
            bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)
        mul = torch.rsqrt(var + bn.eps) * w
        z = (yf - mean[:, None, None]) * mul[:, None, None] \
            + b[:, None, None]
        ba.activation(act, z).backward(gr)

    for dataset, size, path in (("gen1", "base", "train step"),
                                ("gen1", "small", "RVT-S train step"),
                                ("gen4", "base", "gen4 train step")):
        calls = bn_act_calls(dataset, size, 48, "cuda")
        worst = {}
        for y, gr, bn, act in calls:
            pairs, again = bn_act_vs_plain(y, gr, bn, act)
            for k, (got, ref) in pairs.items():
                scale = max(float(ref.abs().max()), 1e-6)
                err = float((got.float() - ref.float()).abs().max()) / scale
                worst[k] = max(worst.get(k, 0.0), err)
                if err > BN_TOL[k] or not torch.equal(got, again[k]):
                    fail(f"bn_act {dataset} {size} {tuple(y.shape)} {k}: "
                         f"{err:.3e} of max|ref| (tolerance {BN_TOL[k]}), "
                         f"equal on a second run: "
                         f"{torch.equal(got, again[k])}")
        log(f"  bn_act[{dataset} {size}]: {len(calls)} calls vs plain, "
            "worst share of max|ref|: " + ", ".join(
                f"{k} {v:.2e} (tol {BN_TOL[k]:g})" for k, v in worst.items()))
        keys = Tally((tuple(y.shape), y.is_contiguous(), act, y.dtype)
                     for y, _, _, act in calls)
        first = {}
        for c in calls:
            first.setdefault((tuple(c[0].shape), c[0].is_contiguous(), c[3],
                              c[0].dtype), c)
        tot = dict(kernel=0.0, chain=0.0, bound=0.0)
        for key, n in keys.items():
            y, gr, bn, act = first[key]
            w, b = bn.weight, bn.bias
            run = (bn.running_mean.clone(), bn.running_var.clone())

            def kern(plain=False):
                mom = ba.moments(y, plain=plain)
                ba.act_fwd(y, mom, 1, w, b, bn.eps, act, run, plain=plain)
                sums, _ = ba.bwd_sums(y, gr, mom, 1, w, b, bn.eps, act,
                                      plain=plain)
                ba.bwd_dy(y, gr, mom, sums, 1, w, b, bn.eps, act,
                          plain=plain)

            leaves = (y.detach().clone().requires_grad_(),
                      w.detach().clone().requires_grad_(),
                      b.detach().clone().requires_grad_())
            with torch.no_grad():
                ms = time_ms(kern)
                dms = device_ms_of(kern)
                pms = time_ms(lambda: kern(True))
            lms = device_ms_of(lambda: chain(y, gr, bn, act, leaves))
            E, isz = y.numel(), y.element_size()
            nbytes = E * (2 * isz + 8)
            log(f"  bn_act[{dataset} {size}] y {key[0]} "
                f"{'NCHW' if key[1] else 'channels_last'} {act} "
                f"{str(key[3])[6:]}, {n} a step:")
            # the other presets' calls are printed, not counted for a path
            rec.add(path, n if path == "train step" else 0,
                    max(worst.values()), ms, pms, nbytes, 0, PEAK_BF16_FLOPS,
                    lms, launches_per_call=4, device_ms=dms)
            tot["kernel"] += n * dms
            tot["chain"] += n * lms
            tot["bound"] += n * nbytes / PEAK_BYTES * 1e3
        log(f"  bn_act[{dataset} {size}] a step ({len(calls)} BaseConvs, 48 "
            f"frames): kernels {tot['kernel']:.3f} ms (device), the "
            f"PyTorch chain {tot['chain']:.3f} ms (device), bound "
            f"{tot['bound']:.3f} ms (bytes)")
        del calls, first
        torch.cuda.empty_cache()
    return rec


def time_fused_stage():
    """Phase 3, row 2: each stage's ``fused_stage`` (K1-K3 over the B
    frames, K4 at T = 1: the raw step's stage) with gen1 RVT-B's weights as
    the serving steps keep them, against its plain version (h and c at
    the pair's tolerances), timed beside its plain version and the least
    time the card could take."""
    import torch

    from rvt_tpu_torch.models.detector import backbone_kernel_params
    from rvt_tpu_torch.ops import fused_scan as fs

    cfg = gen1_base_train_cfg()
    params = backbone_kernel_params(gen1_base_model(cfg))
    att = cfg.model.backbone.attention
    g = torch.Generator(device="cuda").manual_seed(4)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for (H, W, C), prm in zip(STAGES, params):
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device="cuda") * scale
        x = randn(BATCH, H, W, C, scale=2.0).to(torch.bfloat16)
        h0, c0 = randn(BATCH, H, W, C, scale=0.5), randn(BATCH, H, W, C,
                                                         scale=0.5)
        kw = dict(heads=C // att.dim_head, dim_head=att.dim_head,
                  part=tuple(att.partition_size), eps=att.norm_eps,
                  ds_eps=cfg.model.backbone.downsample.norm_eps, **prm)
        got = fs.fused_stage(x, h=h0, c=c0, **kw)
        ref = fs.fused_stage(x, h=h0, c=c0, plain=True, **kw)
        compare(f"fused_stage {H}x{W}x{C} h", got[0], ref[0], 5e-2, 2e-2,
                5e-3)
        compare(f"fused_stage {H}x{W}x{C} c", got[1], ref[1], 1e-1, 2e-2,
                5e-3)
        ms = time_ms(lambda: fs.fused_stage(x, h=h0, c=c0, **kw))
        pms = time_ms(lambda: fs.fused_stage(x, h=h0, c=c0, plain=True,
                                             **kw), 2)
        M, tok = BATCH * H * W, att.partition_size[0] * att.partition_size[1]
        w_bytes = 2 * (2 * (3 + 1 + 4 + 4) * C * C + 8 * C * C)
        nbytes = M * C * (2 + 4 * 4) + w_bytes  # x bf16; h, c in and out
        # two blocks of 12 C^2 MACs per token + attention, the LSTM 8 C^2
        ops = M * (2 * (24 * C * C + 4 * tok * C) + 16 * C * C)
        bound = max(nbytes / PEAK_BYTES, ops / PEAK_BF16_FLOPS) * 1e3
        log(f"    per stage step: kernels {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bound:.4f} ms")
        tot["ms"] += ms
        tot["plain_ms"] += pms
        tot["bound_ms"] += bound
    log(f"fused_stage, 4 stages per raw step: kernels {tot['ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")


def compare_rel(name, got, ref, tol):
    """max |got - ref| <= tol * max |ref|: for sums over many rows, whose
    order differs between the kernel and the plain version. Returns the
    max abs err."""
    import torch

    g, r = got.float(), ref.float()
    scale = max(float(r.abs().max()), 1e-12)
    err = float((g - r).abs().max())
    log(f"  {name}: max|err| {err:.3e} (tolerance {tol:g}*max|ref| = "
        f"{tol * scale:.3e})")
    if not bool(torch.isfinite(g).all()) or err > tol * scale:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


class first_pass_only:
    """Within it the training wrappers skip the in-order sum of their
    partials (``sum_parts`` gives partial 0 back): so K2's gelu backward,
    K5 and K6 are timed without the ``train_reduce`` launch that follows
    each, which is timed on its own at the same partials."""

    def __enter__(self):
        from rvt_tpu_torch.ops import fused_attention as fa
        self.fa, self.saved = fa, fa.sum_parts
        fa.sum_parts = lambda part, **_: part[0]

    def __exit__(self, *exc):
        self.fa.sum_parts = self.saved


def check_train_kernels(recs):
    """Phase 4: the training kernels at the train step's shapes (the pair
    over T*B frames, the LSTM over B lanes and T steps), added to ``recs``
    (new entries for the new kernels) with their calls per train step."""
    import torch
    import torch.nn.functional as F

    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.ops import fused_scan as fs
    from rvt_tpu_torch.ops.kernels import sm_count

    def rec(name, src, replaces):
        return Record(name, f"rvt_tpu_torch/csrc/{src}",
                      f"rvt_tpu/ops/fused_train.py:{replaces}")

    for name, src, line in (
            ("ln_rows_bwd", "ln_rows_bwd.cu", 127),
            ("gemm_bf16_wgrad", "gemm_bf16_wgrad.cu", 158),
            ("partition_attention_bwd", "partition_attention_bwd.cu", 234),
            ("lstm_scan_bwd", "lstm_scan_bwd.cu", 1479),
            ("train_reduce", "train_reduce.cu", 495)):
        if name not in recs:
            recs[name] = rec(name, src, line)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16
    TS = "train step"

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def first(x):
        return x[0] if isinstance(x, tuple) else x

    def plan(what, M, N, itemsize=4):
        p = fa.reduce_plan(M, N, itemsize)
        log(f"  train_reduce plan, {what} [{M}, {N}]: {p.chunks} row chunks "
            f"of {p.rows}, {p.blocks(N)} blocks of {p.tx} x {p.ty} threads, "
            f"{p.vec} columns a thread")

    def sum_parts(label, part, count):
        """``train_reduce``'s in-order sum at partials the path gives it;
        plain = torch's sum over the same partials."""
        plan(f"sum_parts {label}", part.shape[0], part[0].numel())
        err = compare_rel(f"sum_parts[{label} {list(part.shape)}]",
                          fa.sum_parts(part), part.sum(0), 1e-5)
        ms = time_ms(lambda: fa.sum_parts(part))
        dms = device_ms_of(lambda: fa.sum_parts(part))
        pms = time_ms(lambda: fa.sum_parts(part, plain=True))
        lms = time_ms(lambda: torch.sum(part, 0))
        recs["train_reduce"].add(TS, count, err, ms, pms,
                                 4 * (part.numel() + part[0].numel()),
                                 part.numel(), PEAK_F32_FLOPS, lms,
                                 device_ms=dms)
        for k, v in zip(sp, (count, count * ms, count * pms, count * lms,
                             count * dms)):
            sp[k] += v

    T, B, n_frames = SEQ_LEN, BATCH, SEQ_LEN * BATCH
    sms = sm_count(torch.empty(1, device=dev))
    sp = dict(calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0)
    for H, W, C in STAGES:
        M = n_frames * H * W
        rpb = fa._rows_per_block(M)
        log(f"train stage {H}x{W}x{C}: {n_frames} frames, {M} rows")
        # K2: every product of the pair's forward, recompute and backward,
        # with its count per train step (2 blocks; forward + recompute)
        for label, epi, K, N, count in (
                ("qkv", "bias", C, 3 * C, 4),
                ("proj", "residual_ls", C, C, 4),
                ("fc1", "gelu", C, 4 * C, 4),
                ("fc2", "residual_ls", 4 * C, C, 2),
                ("m", "bias", 4 * C, C, 2),
                ("dg", "rt_gelu_bwd", C, 4 * C, 2),
                ("dy", "rt_f32", 4 * C, C, 2),
                ("dattn", "rt_bf16", C, C, 2),
                ("dxa", "rt_f32", 3 * C, C, 1),
                ("dxbf", "rt_acc", 3 * C, C, 1)):
            rt = epi.startswith("rt_")
            a = randn(M, K)
            w = randn(*((N, K) if rt else (K, N)), scale=K ** -0.5)
            kw = {}
            if not rt:
                kw["bias"] = randn(N, scale=0.1)
            if epi == "residual_ls":
                kw.update(gamma=randn(N, scale=0.3, dtype=f32),
                          res_in=randn(M, N, dtype=f32))
            if epi == "rt_gelu_bwd":
                kw["aux"] = randn(M, N)
            R = randn(M, N, dtype=f32) if epi == "rt_acc" else None
            want = epi in ("gelu", "residual_ls")

            def run(plain, out=None):
                return fa.gemm_bf16(a, w, epi, out=out, want_aux=want,
                                    plain=plain, **kw)

            got = run(False, None if R is None else R.clone())
            ref = run(True, None if R is None else R.clone())
            err = compare(f"gemm_bf16[{label} {epi}, "
                          f"{k2_schedule(M, N, K, epi)}]", first(got),
                          first(ref), 3.2e-2, 1e-2)
            if epi == "rt_gelu_bwd":
                compare_rel("  its column sums", got[1], ref[1], 1e-3)
                again = run(False)
                if not (torch.equal(got[0], again[0])
                        and torch.equal(got[1], again[1])):
                    fail("gemm_bf16 rt_gelu_bwd: two runs differ")
                del again
            elif want:
                compare("  its bf16 branch output", got[1], ref[1], 3.2e-2,
                        1e-2)
            del got, ref
            with first_pass_only():
                ms = time_ms(lambda: run(False, R))
            pms = time_ms(lambda: run(True, R), 2)
            lms = time_ms(lambda: torch.matmul(a, w.t() if rt else w))
            per_elem = {"bias": 2, "gelu": 4, "residual_ls": 10,
                        "rt_f32": 4, "rt_bf16": 2, "rt_acc": 8,
                        "rt_gelu_bwd": 4}[epi]
            recs["gemm_bf16"].add(
                TS, count, err, ms, pms, 2 * (M * K + K * N) + M * N * per_elem,
                2 * M * N * K, PEAK_BF16_FLOPS, lms)
            del a, w, kw, R
        sum_parts("gelu-bwd column sums", randn(fa.gemm_part_rows(M), 4 * C,
                                                dtype=f32), 2)
        # K5: LN2 and LN1 (f32 residual in, added into dR), ds-LN (bf16)
        s = randn(C, scale=0.2) + 1.0
        for xdt, add, count in ((f32, True, 3), (bf16, False, 1)):
            x = randn(M, C, scale=2.0, dtype=xdt) + 0.5
            dy = randn(M, C, dtype=f32)
            d0 = randn(M, C, dtype=f32) if add else None

            def run(plain, d=None):
                return fa.ln_rows_bwd(x, dy, s, 1e-5, dres=d, plain=plain)

            got = run(False, None if d0 is None else d0.clone())
            ref = run(True, None if d0 is None else d0.clone())
            lab = "f32 += dx" if add else "bf16 dx"
            err = compare(f"ln_rows_bwd[{lab}] dx", got[0], ref[0],
                          1e-3 if add else 3.2e-2, 1e-2)
            compare_rel("  ds", got[1], ref[1], 1e-3)
            compare_rel("  db", got[2], ref[2], 1e-3)
            del got, ref
            with first_pass_only():
                ms = time_ms(lambda: run(False, d0))
            pms = time_ms(lambda: run(True, d0), 2)
            xr = x.detach().requires_grad_(True)
            sw = s.to(xdt, copy=True).requires_grad_(True)
            bw = torch.zeros_like(sw, requires_grad=True)
            y = F.layer_norm(xr, (C,), sw, bw, 1e-5)
            dyy = dy.to(xdt)
            lms = time_ms(lambda: torch.autograd.grad(y, (xr, sw, bw), dyy,
                                                      retain_graph=True))
            del y, xr
            recs["ln_rows_bwd"].add(
                TS, count, err, ms, pms,
                M * C * (x.element_size() + 4 + (8 if add else 2)),
                20 * M * C, PEAK_F32_FLOPS, lms)
        sum_parts("ln_rows_bwd ds/db", randn(-(-M // rpb), 2, C, dtype=f32),
                  4)
        # K6: every weight gradient (two blocks, the LSTM)
        for label, Ka, Nb, count in (("qkv", C, 3 * C, 2), ("proj", C, C, 2),
                                     ("fc1", C, 4 * C, 2),
                                     ("fc2", 4 * C, C, 2),
                                     ("lstm", 2 * C, 4 * C, 1)):
            a, b = randn(M, Ka), randn(M, Nb)
            got = fa.gemm_bf16_wgrad(a, b)
            err = compare_rel(f"gemm_bf16_wgrad[{label} {Ka}x{Nb}]", got,
                              fa.gemm_bf16_wgrad_plain(a, b), 1e-3)
            if not torch.equal(got, fa.gemm_bf16_wgrad(a, b)):
                fail("gemm_bf16_wgrad: two runs differ")
            with first_pass_only():
                ms = time_ms(lambda: fa.gemm_bf16_wgrad(a, b))
            pms = time_ms(lambda: fa.gemm_bf16_wgrad_plain(a, b), 2)
            lms = time_ms(lambda: torch.matmul(a.t(), b))
            splits = fa.wgrad_splits(M, Ka, Nb, sms)[0]
            recs["gemm_bf16_wgrad"].add(
                TS, count, err, ms, pms,
                2 * M * (Ka + Nb) + 4 * Ka * Nb,
                2 * M * Ka * Nb, PEAK_BF16_FLOPS, lms)
            del a, b, got
            if splits > 1:
                sum_parts(f"wgrad {label}", randn(splits, Ka, Nb, dtype=f32),
                          count)
        # K7: window and grid attention backward
        heads = C // DIM_HEAD
        n_tok = PART[0] * PART[1]
        parts = (H // PART[0]) * (W // PART[1])
        qkv = randn(n_frames, H, W, 3 * C)
        do = randn(n_frames, H, W, C)
        q, k, v = [torch.randn(n_frames * parts, heads, n_tok, DIM_HEAD,
                               generator=g, device=dev, dtype=bf16
                               ).requires_grad_(True) for _ in range(3)]
        o = F.scaled_dot_product_attention(q, k, v)
        do_l = torch.randn(o.shape, generator=g, device=dev, dtype=bf16)
        for window in (True, False):
            kw = dict(heads=heads, dim_head=DIM_HEAD, part=PART,
                      window=window)
            got = fa.partition_attention_bwd(qkv, do, **kw)
            ref = fa.partition_attention_bwd(qkv, do, plain=True, **kw)
            mode = "window" if window else "grid"
            err = compare(f"partition_attention_bwd[{mode}]", got, ref,
                          3.2e-2, 2e-2)
            ms = time_ms(lambda: fa.partition_attention_bwd(qkv, do, **kw))
            pms = time_ms(lambda: fa.partition_attention_bwd(
                qkv, do, plain=True, **kw), 2)
            lms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), do_l,
                                                      retain_graph=True))
            recs["partition_attention_bwd"].add(
                TS, 1, err, ms, pms, M * C * 14, 10 * M * n_tok * C,
                PEAK_BF16_FLOPS, lms)
        del qkv, do, q, k, v, o
        # K4 with c_seq, then K8 (+ K6 for dW, train_reduce for db)
        x = randn(T, B, H, W, C, dtype=f32)
        w = randn(2 * C, 4 * C, scale=(2 * C) ** -0.5)
        bias = randn(4 * C, scale=0.1)
        h0 = randn(B, H, W, C, scale=0.5, dtype=f32)
        c0 = randn(B, H, W, C, scale=0.5, dtype=f32)
        fwd = fs.fused_lstm_scan(x, w, bias, h0, c0, with_c_seq=True)
        ref4 = fs.fused_lstm_scan(x, w, bias, h0, c0, with_c_seq=True,
                                  plain=True)
        err = 0.0
        for nm, gt, rf, tol in zip(("h_seq", "c_seq", "h_T", "c_T"), fwd,
                                   ref4, (2e-2, 5e-2, 2e-2, 5e-2)):
            err = max(err, compare(f"lstm_scan[c_seq] {nm}", gt, rf, tol,
                                   2e-2, 2e-3))
        ms = time_ms(lambda: fs.fused_lstm_scan(x, w, bias, h0, c0,
                                                with_c_seq=True))
        pms = time_ms(lambda: fs.fused_lstm_scan(x, w, bias, h0, c0,
                                                 with_c_seq=True, plain=True),
                      1)
        P = B * H * W
        lms = lstm_library_ms(T, P, C, g, grad=True)
        launches = fs.lstm_scan_launches(T, P, C)
        recs["lstm_scan"].add(
            TS, 1, err, ms, pms,
            T * P * C * (4 + 2 + 4) + 2 * (8 * C * C + 4 * C) + 4 * P * C * 4,
            2 * T * P * 2 * C * 4 * C, PEAK_BF16_FLOPS, lms,
            launches_per_call=launches)
        K4_STAGES.append((TS, f"{H}x{W}x{C}", T, P, launches, ms, lms))
        h_seq, c_seq = ref4[0], ref4[1]
        del fwd, ref4
        dh_seq = randn(T, B, H, W, C, scale=0.5)
        dhT = randn(B, H, W, C, scale=0.5, dtype=f32)
        dcT = randn(B, H, W, C, scale=0.5, dtype=f32)
        args = (x, w, bias, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT)
        got = fs.lstm_scan_bwd(*args)
        ref = fs.lstm_scan_bwd(*args, plain=True)
        err = 0.0
        for nm, gt, rf in zip(("dx", "dW", "db", "dh0", "dc0"), got, ref):
            err = max(err, compare_rel(f"lstm_scan_bwd {nm}", gt, rf, 2e-2))
        del got, ref
        # K8 timed as the whole composition its counter counts (pack, the
        # gates' and dx's K2 products, the scan); K6 and the db sum apart
        ms = time_ms(lambda: fs.lstm_scan_bwd_launch(*args))
        pms = time_ms(lambda: fs.lstm_scan_bwd(*args, plain=True), 1)
        lms = lstm_library_ms(T, P, C, g, backward=True)
        launches = fs.lstm_scan_bwd_launches(T, P, C)
        recs["lstm_scan_bwd"].add(
            TS, 1, err, ms, pms, T * P * C * 28 + 2 * (8 * C * C + 4 * C),
            32 * T * P * C * C, PEAK_BF16_FLOPS, lms,
            launches_per_call=launches)
        K8_STAGES.append((TS, f"{H}x{W}x{C}", T, P, launches, ms, lms,
                          k8_parts_ms(*args)))
        del x, h_seq, c_seq, dh_seq, args
        sum_parts("lstm db", randn(fs.lstm_scan_bwd_part_rows(T, P, C),
                                   4 * C, dtype=f32), 1)
        # train_reduce: the LayerScale backward and the qkv-bias column
        # sums, each one launch (its partials summed by its last block)
        plan("layer_scale_bwd", M, C)
        dR, v = randn(M, C, dtype=f32), randn(M, C)
        gam = randn(C, scale=0.3, dtype=f32)
        got = fa.layer_scale_bwd(dR, v, gam)
        ref = fa.layer_scale_bwd_plain(dR, v, gam)
        if not torch.equal(got[0], ref[0]):
            fail("layer_scale_bwd: bf16(dR * gamma) differs")
        err = max(compare_rel("layer_scale_bwd dbias", got[1], ref[1], 1e-4),
                  compare_rel("layer_scale_bwd dgamma", got[2], ref[2],
                              1e-4))
        if not all(torch.equal(a, b) for a, b in zip(
                got, fa.layer_scale_bwd(dR, v, gam))):
            fail("layer_scale_bwd: two runs differ")
        del got, ref
        ms = time_ms(lambda: fa.layer_scale_bwd(dR, v, gam))
        dms = device_ms_of(lambda: fa.layer_scale_bwd(dR, v, gam))
        pms = time_ms(lambda: fa.layer_scale_bwd_plain(dR, v, gam))
        # one of the kernel's three outputs: the bias gradient
        lms = time_ms(lambda: (dR * gam).sum(0))
        recs["train_reduce"].add(TS, 4, err, ms, pms, M * C * 8, 4 * M * C,
                                 PEAK_F32_FLOPS, lms, device_ms=dms)
        plan("col_sum", M, 3 * C, 2)
        dq = randn(M, 3 * C)
        got = fa.col_sum(dq)
        err = compare_rel("col_sum[dqkv]", got, dq.float().sum(0), 1e-4)
        if not torch.equal(got, fa.col_sum(dq)):
            fail("col_sum: two runs differ")
        ms = time_ms(lambda: fa.col_sum(dq))
        dms = device_ms_of(lambda: fa.col_sum(dq))
        pms = time_ms(lambda: dq.float().sum(0))
        lms = time_ms(lambda: torch.sum(dq, 0, dtype=f32))
        recs["train_reduce"].add(TS, 2, err, ms, pms, M * 3 * C * 2,
                                 M * 3 * C, PEAK_F32_FLOPS, lms,
                                 device_ms=dms)
        del dR, v, dq
        torch.cuda.empty_cache()
    log(f"sum_parts of K2's gelu backward, K5, K6 and K8, per {TS}: "
        f"{sp['calls']} calls, kernel {sp['ms']:.4f} ms (device "
        f"{sp['device_ms']:.4f} ms), plain {sp['plain_ms']:.4f} ms, "
        f"torch.sum {sp['library_ms']:.4f} ms")


def train_batch(cfg):
    """The profile_train.py batch on the card: uint8 events in [0, 8) of
    [B, T, H, W, 20] at the dataset's resolution from numpy seed 0; three
    boxes on every 5th frame; no lane restarting."""
    import numpy as np
    import torch

    B, T = BATCH, SEQ_LEN
    H, W = cfg.dataset.dataloading_hw
    M = cfg.dataset.max_labels_per_frame
    rng = np.random.RandomState(0)
    ev = rng.randint(0, 8, size=(B, T, H, W, 20)).astype(np.uint8)
    labels = np.zeros((B, T, M, 7), np.float32)
    label_mask = np.zeros((B, T, M), bool)
    for t in range(LABEL_EVERY - 1, T, LABEL_EVERY):
        labels[:, t, :3] = [(0, 100.0, 80.0, 40.0, 30.0, 0.0, 1.0),
                            (0, 30.0, 40.0, 25.0, 20.0, 1.0, 1.0),
                            (0, 200.0, 120.0, 50.0, 35.0, 0.0, 1.0)]
        label_mask[:, t, :3] = True
    return tuple(torch.from_numpy(a).cuda() for a in (
        ev, labels, label_mask, label_mask.any(-1), np.zeros(B, bool)))


def gen1_base_train_cfg():
    """The train cell's config: gen1 RVT-B, bf16, the train kernels, no
    s2d stem."""
    from dataclasses import replace

    from rvt_tpu_torch.config import preset

    cfg = preset("gen1", "base")
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True)))


def gen1_base_model(cfg):
    """Random weights from seed 0 on the card, LayerScale gammas drawn at
    0.1 so that the attention blocks shape the output."""
    import torch

    from rvt_tpu_torch.models.detector import init_detector

    model = init_detector(cfg.model, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
    return model


def time_stage_step_train():
    """Phase 4, row 7 (``fused_stage_step_train``, forward and backward)
    per call at each stage with gen1 RVT-B's weights, B frames, against
    its plain version: every output and gradient within 5e-2 of max|ref|.
    Returns its Record (T calls per stage a window of the per-step train
    backbone)."""
    import torch

    from rvt_tpu_torch.models.detector import downsample_ln_params
    from rvt_tpu_torch.ops import fused_train as ft

    cfg = gen1_base_train_cfg()
    model = gen1_base_model(cfg)
    rec = Record("fused_stage_step_train", "rvt_tpu_torch/ops/fused_train.py",
                 "rvt_tpu/ops/fused_train.py:770")
    att = cfg.model.backbone.attention
    g = torch.Generator(device="cuda").manual_seed(7)
    tok = PART[0] * PART[1]

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            dtype)

    for stage, (H, W, C) in zip(model.backbone.stages, STAGES):
        blk, lstm = stage.att_blocks[0], stage.lstm.conv1x1
        with torch.no_grad():
            prm = [*downsample_ln_params(stage, cfg.model.backbone, C),
                   *ft.train_block_params(blk.att_window, True),
                   *ft.train_block_params(blk.att_grid, False),
                   lstm.weight[:, :, 0, 0].to(torch.bfloat16).t(),
                   lstm.bias.to(torch.bfloat16)]
        prm = [p.detach().contiguous().requires_grad_(True) for p in prm]
        x = randn(BATCH, H, W, C, scale=2.0,
                  dtype=torch.bfloat16).requires_grad_(True)
        h = randn(BATCH, H, W, C, scale=0.5).requires_grad_(True)
        c = randn(BATCH, H, W, C, scale=0.5).requires_grad_(True)
        dh, dc = randn(BATCH, H, W, C), randn(BATCH, H, W, C)
        leaves = [x] + prm + [h, c]
        n_win = len(prm) - 2 - 2 - ft._N_TRAIN

        def call(plain):
            scfg = ft.StageCfg(C // att.dim_head, att.dim_head, PART,
                               att.norm_eps,
                               cfg.model.backbone.downsample.norm_eps, plain)
            out = ft.fused_stage_step_train(
                scfg, x, prm[0], prm[1], prm[2:2 + n_win],
                prm[2 + n_win:2 + n_win + ft._N_TRAIN], prm[-2], prm[-1], h,
                c)
            grads = torch.autograd.grad(out, leaves, (dh, dc))
            return [o.detach() for o in out] + list(grads)

        got, ref = call(False), call(True)
        err = max(compare_rel(f"fused_stage_step_train {H}x{W}x{C} "
                              f"{'output' if i < 2 else 'gradient'} {i}", a,
                              b, 5e-2) for i, (a, b) in enumerate(zip(got,
                                                                     ref)))
        del got, ref
        ms = time_ms(lambda: call(False))
        pms = time_ms(lambda: call(True), 2)
        P = BATCH * H * W
        wbytes = 2 * (2 * 12 * C * C + 8 * C * C)
        # x, dx bf16; h, c, h_t, c_t, dh_t, dc_t, dh, dc f32; the weights
        # read, every gradient written; 3x the forward's operations
        rec.add("per-step train", SEQ_LEN, err, ms, pms,
                P * C * (2 * 2 + 8 * 4) + 2 * wbytes,
                3 * P * (2 * (24 * C * C + 4 * tok * C) + 16 * C * C),
                PEAK_BF16_FLOPS, None)
        del x, h, c, dh, dc, prm, leaves
    return rec


def compare_rel_quiet(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-12)


def stage_bounds():
    """The least time the card could take for four composed TPU kernels
    of the kernel table, from their shapes: row 3 (``fused_stage_scan``,
    the eval window's stage: x_seq bf16 in, h_seq bf16 out, h/c in and
    out, both blocks' and the LSTM's weights once), row 5
    (``fused_conv_lstm``, the raw step's cell at T = 1 on the f32 pair
    output), row 7 (``fused_stage_step_train`` forward and backward, T
    calls: each reads x, h, c, dh_t, dc_t and the weights and writes h_t,
    c_t, dx, dh, dc and every gradient; three times the forward's
    operations) and row 8 (``fused_stage_scan_train`` forward and
    backward: x_seq, h0, c0 and the weights in, h_seq, hT, cT and every
    gradient out; three times the forward's operations). Sums over the
    four stages; prints and returns {row: (bound ms, by)}."""
    out = {}
    tok = PART[0] * PART[1]
    for row, what in ((3, "eval window"), (5, "raw step"),
                      (7, f"per-step train window of {SEQ_LEN} calls"),
                      (8, "train step")):
        nbytes = ops = 0
        for (H, W, C) in STAGES:
            B = BATCH
            T = 1 if row == 5 else SEQ_LEN
            M, P = T * B * H * W, B * H * W
            wbytes = 2 * (2 * 12 * C * C + 8 * C * C)
            pair_ops = M * 2 * (24 * C * C + 4 * tok * C)
            lstm_ops = M * 16 * C * C
            if row == 3:
                nbytes += M * C * 4 + 4 * P * C * 4 + wbytes
                ops += pair_ops + lstm_ops
            elif row == 5:
                nbytes += P * C * (4 + 2 + 4 * 4) + 2 * 8 * C * C
                ops += lstm_ops
            elif row == 7:
                # per call: x, dx bf16; h, c, h_t, c_t, dh_t, dc_t, dh, dc
                # f32; the weights read and every gradient written
                nbytes += SEQ_LEN * (P * C * (2 * 2 + 8 * 4) + 2 * wbytes)
                ops += 3 * SEQ_LEN * (pair_ops + lstm_ops) // T
            else:
                # in: x_seq, dh_seq (bf16), h0, c0, dhT, dcT; out: dx_seq
                # (bf16), h_seq, hT, cT, dh0, dc0; weights and gradients
                nbytes += M * C * 8 + 10 * P * C * 4 + 2 * wbytes
                ops += 3 * (pair_ops + lstm_ops)
        b_ms = nbytes / PEAK_BYTES * 1e3
        o_ms = ops / PEAK_BF16_FLOPS * 1e3
        by = "bytes" if b_ms >= o_ms else "operations"
        out[row] = (max(b_ms, o_ms), by)
        log(f"row {row} bound per {what}, 4 stages: {max(b_ms, o_ms):.4f} "
            f"ms ({by}; bytes {b_ms:.4f} ms, operations {o_ms:.4f} ms)")
    return out


def path_launches():
    """Phase 5's counts: each kernel's launches in one eager call each of
    the eval, raw and train steps of gen1 RVT-B at the benchmark cells'
    shapes (bf16, B = 8, T = 21; the eval step with the s2d stem, fed the
    stored window's channel-last view; the raw step on 8 lanes of 32,768
    events; pre_nms_topk 512 as phase 3 times NMS; the train step without
    the s2d stem and token masks), and in one forward and backward of the
    per-step train backbone (``fused_train_scan_backbone(per_step=True)``,
    row 7's window) over the train step's window. Counts only: the
    benchmark times the steps and holds them against its reference.
    Returns {path: {kernel: launches}}."""
    from dataclasses import replace

    import torch

    from rvt_tpu_torch.inference import make_raw_inference_step
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import fused_train_scan_backbone
    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.ops.kernels import COUNTERS, TALLIES
    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import (make_eval_step, make_train_step,
                                             pad_ev_repr)

    train = gen1_base_train_cfg()
    bb = train.model.backbone
    if bb.stem_s2d or bb.enable_masking:
        fail("the train cell runs without the s2d stem and token masks")
    raw = replace(train, model=replace(train.model, postprocess=replace(
        train.model.postprocess, pre_nms_topk=512)))
    serve = replace(raw, model=replace(raw.model, backbone=replace(
        bb, stem_s2d=True)))
    g = torch.Generator(device="cuda").manual_seed(3)

    def ints(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device="cuda",
                             dtype=dtype)

    states = zero_states(bb, BATCH, device="cuda")
    first = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    stored = ints(8, (BATCH, SEQ_LEN, 20, 240, 304), torch.uint8)
    fv = (torch.arange(SEQ_LEN, device="cuda") % LABEL_EVERY
          == LABEL_EVERY - 1).repeat(BATCH, 1)
    events = (ints(304, (BATCH, EVENTS)), ints(240, (BATCH, EVENTS)),
              ints(2, (BATCH, EVENTS)),
              torch.sort(ints(50_000, (BATCH, EVENTS)), dim=1).values,
              torch.full((BATCH,), EVENTS - 17, dtype=torch.int32,
                         device="cuda"))
    model = gen1_base_model(train)
    batch = train_batch(train)

    def per_step_window(states, ev):
        seq = pad_ev_repr(ev, bb.in_res_hw, torch.float32).transpose(0, 1)
        feats, final = fused_train_scan_backbone(model, seq, states,
                                                 per_step=True)
        sum(t.float().sum() for t in (*feats, *(x for hc in final
                                                 for x in hc))).backward()

    steps = {
        "eval step": (make_eval_step(gen1_base_model(serve), serve),
                      (stored.permute(0, 1, 3, 4, 2), fv, first)),
        "raw step": (make_raw_inference_step(gen1_base_model(raw), raw),
                     (*events, first)),
        "train step": (make_train_step(model, train, make_optimizer(
            model.parameters(), train.training)), batch),
        "per-step train": (per_step_window, batch[:1])}
    made = {}
    for path, (step, args) in steps.items():
        for c in COUNTERS + TALLIES:
            c.reset()
        with graphs.eager():
            step(states, *args)
        made[path] = {c.name: c.launches for c in COUNTERS if c.launches}
        log(f"launches of one {path}: {made[path]}")
        pp = fa.GEMM_BF16_PINGPONG.launches
        k2 = pp + fa.GEMM_BF16_COOPERATIVE.launches
        PINGPONG_SHARE[path] = pp / k2 if k2 else 0.0
        log(f"K2 schedules in one {path}: ping-pong {pp} of {k2} launches "
            f"({PINGPONG_SHARE[path]:.1%}; K4's and K8's products "
            "included)")
        torch.cuda.empty_cache()
    return made


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from rvt_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the rvt_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    global CARD
    card = CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    stage_bounds()
    recs = check_kernels()
    time_fused_stage()
    check_gemm_edges()
    check_attention_lstm_edges()
    recs["stacked_histogram"] = check_voxelizer()
    recs["nms_keep"] = check_nms_keep()
    recs["window_s2d"] = check_window_s2d()
    recs["bn_act"] = check_bn_act()
    check_train_kernels(recs)
    recs["fused_stage_step_train"] = time_stage_step_train()
    log(f"LSTM yardstick dtypes: {LSTM_LIB}")
    torch.cuda.empty_cache()
    made = path_launches()
    # the calls each record timed for one call of a path must be the
    # launches that call made; on the eval, raw and train steps every
    # launch is timed (on the per-step window, row 7's calls: the kernels
    # inside them are timed at the train step's shapes)
    for path, launched in made.items():
        for name, n in launched.items():
            if path != "per-step train" and (
                    name not in recs or path not in recs[name].paths):
                fail(f"{name}: {n} launches per {path} made, none timed")
    for path in ("eval step", "train step"):
        if not PINGPONG_SHARE.get(path):
            fail(f"no K2 launch of one {path} took the ping-pong schedule")
    for name, rec in recs.items():
        by_path = {path: n.get(name, 0) for path, n in made.items()}
        rec.d["launches"] = sum(by_path.values())
        rec.d["launches_by_path"] = by_path
        for path, q in rec.paths.items():
            if q["launches"] != by_path.get(path):
                fail(f"{name}: {q['launches']} launches per {path} timed, "
                     f"{by_path.get(path, 'no path run that')} made")
    log_lstm_stages()
    log(f"card: {card}; {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": [r.d for r in recs.values()]}))
    return 0

if __name__ == "__main__":
    sys.exit(main())

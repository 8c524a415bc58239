#!/usr/bin/env python3
"""Smoke check of the PyTorch port (rvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

  1. report the card (name and power limit, from nvidia-smi);
  2. build the five CUDA kernels from rvt_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, at
     every gen1 RVT-B stage shape (T*B = 168 frames): ln_rows on bf16 and
     f32 rows, gemm_bf16 with each epilogue at the qkv/proj/fc1/fc2
     shapes, partition_attention in window and grid mode, lstm_scan at
     T = 21 and at T = 1; and stacked_histogram with zero error on gen1
     events (8 x 32768 over 240x304), on gen4 events retargeted into the
     360x640 half grid, on a lane whose events all hit one pixel and on a
     lane with out-of-range and past-counts events. Prints the error
     beside its tolerance and the kernel's, plain version's and one
     library call's times (CUDA events), with the least time the card
     could take (bound);
  4. run the port's RVT-B gen1 streaming eval step (bf16, s2d stem,
     B = 8, T = 21, labels on every 5th frame, pre_nms_topk 512) over
     several windows with the LSTM states carried, random weights from a
     seed; check that every kernel's launch count rose, that the
     detections are finite, and that one window agrees with the same
     step run through the plain versions; print frames/s and MFU;
  5. run the port's RVT-B gen1 raw-event step (events -> voxelizer ->
     single-step detector -> NMS; bf16, no s2d stem, B = 8 lanes of
     32768 events, pre_nms_topk 512) for 1 + 21 calls with the states
     carried; check that all five kernels were launched, that the
     detections are finite, and that one call agrees with the plain
     versions (identical histogram); time each stage's ``fused_stage``
     against its plain version; print frames/s, ms per batch-frame, MFU
     and the idle share of one profiled call;
  6. print the kernels line, then the device line last.

It imports nothing of JAX. It exits 2 without a CUDA device or without
the rvt_tpu_torch package beside it.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
BATCH, SEQ_LEN, LABEL_EVERY, WINDOWS = 8, 21, 5, 4
EVENTS, RAW_FRAMES, RAW_CALLS = 32768, 4, 21
STAGES = ((64, 80, 64), (32, 40, 128), (16, 20, 256), (8, 10, 512))
PART, DIM_HEAD = (8, 10), 32


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
    """One kernel's entry of the kernels line: sums over its launches in
    one step of the path it serves (count x per-launch time), the
    largest error seen."""

    def __init__(self, name, source, replaces, per="eval step"):
        self.per = per
        self.d = dict(name=name, route="cuda", source=source,
                      replaces=replaces, launches=0, max_abs_err=0.0,
                      ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None,
                      library_ms=None)
        self.bytes_ms = 0.0
        self.ops_ms = 0.0

    def add(self, count, err, ms, plain_ms, nbytes, ops, peak, lib_ms):
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], err)
        b_ms, o_ms = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"    per launch: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {max(b_ms, o_ms):.4f} ms "
            f"({'bytes' if b_ms >= o_ms else 'operations'}); "
            f"{count} per {self.per}")
        if count == 0:
            return
        d["ms"] += count * ms
        d["plain_ms"] += count * plain_ms
        self.bytes_ms += count * nbytes / PEAK_BYTES * 1e3
        self.ops_ms += count * ops / peak * 1e3
        d["bound_ms"] = max(self.bytes_ms, self.ops_ms)
        d["bound_by"] = "bytes" if self.bytes_ms >= self.ops_ms else "operations"
        if lib_ms is not None:
            d["library_ms"] = (d["library_ms"] or 0.0) + count * lib_ms


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


def check_kernels():
    """Phase 3, at the main path's shapes (T*B frames through the pair,
    B lanes through the scan). Returns {kernel name: Record}."""
    import torch
    import torch.nn.functional as F

    from rvt_tpu_torch.ops import fused_attention as fa
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

    T, B, n_frames = SEQ_LEN, BATCH, SEQ_LEN * BATCH
    for (H, W, C) in STAGES:
        M = n_frames * H * W
        log(f"stage {H}x{W}x{C}: {n_frames} frames, {M} rows")
        s, b = randn(C, scale=0.2) + 1.0, randn(C, scale=0.2)
        # K1: the ds-LN reads the bf16 conv output, LN1/LN2 the f32 residual
        for dtype, count in ((torch.bfloat16, 1), (torch.float32, 3)):
            x = randn(M, C, scale=2.0, dtype=dtype) + 0.5
            y = fa.ln_rows(x, s, b, 1e-5)
            ref = fa.ln_rows_plain(x, s, b, 1e-5)
            err = compare(f"ln_rows[{str(dtype)[6:]}]", y, ref, 3.2e-2, 1e-2)
            ms = time_ms(lambda: fa.ln_rows(x, s, b, 1e-5))
            pms = time_ms(lambda: fa.ln_rows_plain(x, s, b, 1e-5))
            sw, bw = s.to(dtype), b.to(dtype)
            lms = time_ms(lambda: F.layer_norm(x, (C,), sw, bw, 1e-5))
            recs["ln_rows"].add(count, err, ms, pms,
                                M * C * (x.element_size() + 2) + 4 * C,
                                8 * M * C, PEAK_F32_FLOPS, lms)
        # K2: every product of the two sub-blocks
        for label, K, N, epi in (("qkv", C, 3 * C, "bias"),
                                 ("proj", C, C, "residual"),
                                 ("fc1", C, 4 * C, "gelu"),
                                 ("fc2", 4 * C, C, "residual")):
            a = randn(M, K)
            w = randn(K, N, scale=K ** -0.5)
            bias = randn(N, scale=0.1)
            R0 = randn(M, N, dtype=torch.float32) if epi == "residual" else None
            got = fa.gemm_bf16(a, w, bias, epi,
                               R0.clone() if R0 is not None else None)
            ref = fa.gemm_bf16_plain(a, w, bias, epi,
                                     R0.clone() if R0 is not None else None)
            err = compare(f"gemm_bf16[{label} {epi}]", got, ref, 3.2e-2,
                          1e-2)
            R1 = R0.clone() if R0 is not None else None
            ms = time_ms(lambda: fa.gemm_bf16(a, w, bias, epi, R1))
            pms = time_ms(lambda: fa.gemm_bf16_plain(a, w, bias, epi, R1))
            lms = time_ms(lambda: torch.matmul(a, w))
            out_bytes = M * N * (8 if epi == "residual" else 2)
            recs["gemm_bf16"].add(2, err, ms, pms,
                                  2 * (M * K + K * N + N) + out_bytes,
                                  2 * M * N * K, PEAK_BF16_FLOPS, lms)
        # K3: window and grid attention
        heads = C // DIM_HEAD
        n_tok = PART[0] * PART[1]
        parts = (H // PART[0]) * (W // PART[1])
        qkv = randn(n_frames, H, W, 3 * C)
        for window in (True, False):
            kw = dict(heads=heads, dim_head=DIM_HEAD, part=PART,
                      window=window)
            got = fa.partition_attention(qkv, **kw)
            ref = fa.partition_attention_plain(qkv, heads, DIM_HEAD, PART,
                                               window)
            mode = "window" if window else "grid"
            err = compare(f"partition_attention[{mode}]", got, ref,
                          3.2e-2, 1e-2)
            ms = time_ms(lambda: fa.partition_attention(qkv, **kw))
            pms = time_ms(lambda: fa.partition_attention_plain(
                qkv, heads, DIM_HEAD, PART, window))
            q, k, v = [torch.randn(n_frames * parts, heads, n_tok, DIM_HEAD,
                                   generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(3)]
            lms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            recs["partition_attention"].add(
                1, err, ms, pms, M * 4 * C * 2,
                4 * n_frames * parts * heads * n_tok * n_tok * DIM_HEAD,
                PEAK_BF16_FLOPS, lms)
        # K4: the window scan on the f32 residual (main path) and T = 1
        w = randn(2 * C, 4 * C, scale=(2 * C) ** -0.5)
        bias = randn(4 * C, scale=0.1)
        h0 = randn(B, H, W, C, scale=0.5, dtype=torch.float32)
        c0 = randn(B, H, W, C, scale=0.5, dtype=torch.float32)
        for steps, dtype in ((T, torch.float32), (1, torch.bfloat16)):
            x = randn(steps, B, H, W, C, dtype=dtype)
            got = fs.fused_lstm_scan(x, w, bias, h0, c0)
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
            ms = time_ms(lambda: fs.fused_lstm_scan(x, w, bias, h0, c0))
            pms = time_ms(lambda: fs.lstm_scan_plain(x, w, bias, h0, c0), 2)
            P = B * H * W
            nbytes = (steps * P * C * (x.element_size() + 2)
                      + 2 * (8 * C * C + 4 * C) + 4 * P * C * 4)
            recs["lstm_scan"].add(1 if steps == T else 0, err, ms, pms,
                                  nbytes, 2 * steps * P * 2 * C * 4 * C,
                                  PEAK_BF16_FLOPS, None)
        torch.cuda.empty_cache()
    return recs


def run_main_path():
    """Phase 4. Returns (frames/s, MFU %, launch counts by kernel)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.ops.fused_attention import (GEMM_BF16, LN_ROWS,
                                                   PARTITION_ATTENTION)
    from rvt_tpu_torch.ops.fused_scan import LSTM_SCAN
    from rvt_tpu_torch.ops.s2d import host_space_to_depth
    from rvt_tpu_torch.training.step import make_eval_step
    from rvt_tpu_torch.utils.flops import detector_flops_per_frame

    cfg = preset("gen1", "base")
    cfg = replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, stem_s2d=True,
                         fused_kernels=True),
        postprocess=replace(cfg.model.postprocess, pre_nms_topk=512)))
    model = init_detector(cfg.model, seed=0, device="cuda")
    # LayerScale starts at 1e-5; random gammas of 0.1 make the attention
    # blocks shape the output, so the comparison below sees them.
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
    H, W = cfg.model.backbone.in_res_hw
    rng = np.random.RandomState(0)
    ev_raw = rng.randint(0, 8, size=(BATCH, SEQ_LEN, 240, 304, 20)
                         ).astype(np.uint8)
    ev = torch.from_numpy(host_space_to_depth(ev_raw, (H, W))).cuda()
    frame_valid = torch.from_numpy(
        (np.arange(SEQ_LEN) % LABEL_EVERY == LABEL_EVERY - 1)[None].repeat(
            BATCH, 0)).cuda()
    is_first = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    states = zero_states(cfg.model.backbone, BATCH, device="cuda")
    step = make_eval_step(model, cfg)
    counters = (LN_ROWS, GEMM_BF16, PARTITION_ATTENTION, LSTM_SCAN)

    for c in counters:
        c.reset()
    out = step(states, ev, frame_valid, is_first)  # first window: warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WINDOWS - 1):
        out = step(out.states, ev, frame_valid, is_first)
    dets_sum = float(out.dets.sum())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {c.name: c.launches for c in counters}
    log(f"main path: {WINDOWS} windows, launches {counts}")
    for name, n in counts.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")

    if not np.isfinite(dets_sum) or tuple(out.dets.shape) != (
            BATCH, cfg.dataset.max_labeled_frames,
            cfg.model.postprocess.max_detections, 7):
        fail(f"bad detections: shape {tuple(out.dets.shape)}, sum {dets_sum}")
    log(f"detections: {int(out.det_valid.sum())} valid, "
        f"frame_idx {out.frame_idx[0].tolist()}")

    # one window, kernels vs plain versions on the card
    plain = make_eval_step(model, cfg, plain=True)
    got = step(out.states, ev, frame_valid, is_first)
    ref = plain(out.states, ev, frame_valid, is_first)
    for i, ((hg, cg), (hr, cr)) in enumerate(zip(got.states, ref.states)):
        compare(f"stage {i + 1} h_T vs plain", hg, hr, 5e-2, 2e-2, 5e-3)
        compare(f"stage {i + 1} c_T vs plain", cg, cr, 1e-1, 2e-2, 5e-3)
    scale = max(float(ref.preds.abs().max()), 1.0)
    diff = (got.preds - ref.preds).abs()
    log(f"  head outputs vs plain: max|err| {float(diff.max()):.3e} "
        f"mean|err| {float(diff.mean()):.3e} (tolerance max 0.05*{scale:.1f},"
        f" mean 5e-3*{scale:.1f})")
    if float(diff.max()) > 0.05 * scale or float(diff.mean()) > 5e-3 * scale:
        fail("head outputs disagree with the plain versions")
    if not torch.equal(got.frame_idx, ref.frame_idx):
        fail("frame_idx differs from the plain versions")

    profile_window(lambda: step(out.states, ev, frame_valid, is_first),
                   "window")
    fps = BATCH * SEQ_LEN * (WINDOWS - 1) / dt
    flops = detector_flops_per_frame(cfg.model)["total"]
    mfu = 100.0 * fps * flops / PEAK_BF16_FLOPS
    log(f"eval step: {fps:.1f} frames/s, {fps * flops / 1e12:.2f} TFLOP/s, "
        f"MFU {mfu:.2f}% of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16")
    return fps, mfu, counts


def check_voxelizer():
    """Phase 3, the voxelizer: stacked_histogram against its plain version
    with zero error on five event sets. Returns its Record (timed at the
    raw path's gen1 shape, one launch per raw step)."""
    import torch

    from rvt_tpu_torch.inference import ds2_retarget
    from rvt_tpu_torch.ops import voxelization as vx

    rec = Record("stacked_histogram",
                 "rvt_tpu_torch/csrc/stacked_histogram.cu",
                 "rvt_tpu/ops/voxelization.py:127", per="raw step")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    B, N, bins = BATCH, EVENTS, 10

    def events(H, W):
        def ints(hi):
            return torch.randint(0, hi, (B, N), generator=g, device=dev,
                                 dtype=torch.int32)
        t = torch.sort(ints(50_000), dim=1).values
        counts = torch.full((B,), N - 17, dtype=torch.int32, device=dev)
        return [ints(W), ints(H), ints(2), t, counts]

    def check(label, ev, H, W):
        got = vx.stacked_histogram_batched(*ev, bins, H, W)
        ref = vx.stacked_histogram_plain(*ev, bins, H, W)
        err = float((got.int() - ref.int()).abs().max())
        log(f"  stacked_histogram[{label}]: max|err| {err:g} (tolerance 0: "
            f"integer counts), {int(ref.sum())} events counted, "
            f"max count {int(ref.max())}")
        if not torch.equal(got, ref):
            fail(f"stacked_histogram[{label}] differs from its plain version")
        return got, err

    log(f"voxelizer: {B} lanes x {N} events")
    ev = events(240, 304)
    _, err = check("gen1 240x304", ev, 240, 304)
    # gen4: full-sensor events, the ds2-direct retarget into 360x640, also
    # held against voxelizing 720x1280 and taking every odd pixel
    ev4 = events(720, 1280)
    x2, y2 = ds2_retarget(ev4[0], ev4[1], bins, 360, 640)
    half, e = check("gen4 ds2 360x640", [x2, y2] + ev4[2:], 360, 640)
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

    H, W = 240, 304
    plane = 2 * bins * H * W
    ms = time_ms(lambda: vx.stacked_histogram_batched(*ev, bins, H, W), 20)
    pms = time_ms(lambda: vx.stacked_histogram_plain(*ev, bins, H, W))
    flat = vx.flat_bins(*ev, bins, H, W).reshape(-1)
    lms = time_ms(lambda: torch.bincount(flat, minlength=B * plane + 1), 20)
    n_valid = int(torch.clamp(ev[4], 0, N).sum())
    # each kept event's x, y, p, t read once, counts read, uint8 out;
    # ~10 operations per event for its bin, one per output bin to narrow
    rec.add(1, err, ms, pms, 16 * n_valid + 4 * B + B * plane,
            10 * n_valid + B * plane, PEAK_F32_FLOPS, lms)
    return rec


def run_raw_path():
    """Phase 5. Returns (frames/s, MFU %, launch counts by kernel)."""
    from dataclasses import replace

    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.inference import event_frames, make_raw_inference_step
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import (backbone_kernel_params,
                                               init_detector)
    from rvt_tpu_torch.ops import fused_scan as fs
    from rvt_tpu_torch.ops.fused_attention import (GEMM_BF16, LN_ROWS,
                                                   PARTITION_ATTENTION)
    from rvt_tpu_torch.ops.voxelization import STACKED_HISTOGRAM
    from rvt_tpu_torch.training.step import reset_states
    from rvt_tpu_torch.utils.flops import detector_flops_per_frame

    cfg = preset("gen1", "base")
    cfg = replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, stem_s2d=False,
                         fused_kernels=True),
        postprocess=replace(cfg.model.postprocess, pre_nms_topk=512)))
    model = init_detector(cfg.model, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():  # LayerScale gammas as phase 4 draws them
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
    # distinct event frames, made on the card: no copy in the timed loop
    H, W = cfg.dataset.resolution_hw
    g = torch.Generator(device="cuda").manual_seed(3)

    def ints(hi):
        return torch.randint(0, hi, (BATCH, EVENTS), generator=g,
                             device="cuda", dtype=torch.int32)

    counts = torch.full((BATCH,), EVENTS - 17, dtype=torch.int32,
                        device="cuda")
    frames = [(ints(W), ints(H), ints(2),
               torch.sort(ints(50_000), dim=1).values, counts)
              for _ in range(RAW_FRAMES)]
    is_first = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    states = zero_states(cfg.model.backbone, BATCH, device="cuda")
    step = make_raw_inference_step(model, cfg)
    counters = (LN_ROWS, GEMM_BF16, PARTITION_ATTENTION, fs.LSTM_SCAN,
                STACKED_HISTOGRAM)

    for c in counters:
        c.reset()
    states, dets, valid = step(states, *frames[0], is_first)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RAW_CALLS):
        states, dets, valid = step(states, *frames[(i + 1) % RAW_FRAMES],
                                   is_first)
    dets_sum = float(dets.sum())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts_by = {c.name: c.launches for c in counters}
    log(f"raw path: 1 + {RAW_CALLS} calls, launches {counts_by}")
    for name, n in counts_by.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the raw path")
    md = cfg.model.postprocess.max_detections
    if not math.isfinite(dets_sum) or tuple(dets.shape) != (BATCH, md, 7):
        fail(f"bad raw detections: shape {tuple(dets.shape)}, "
             f"sum {dets_sum}")
    log(f"raw detections: {int(valid.sum())} valid")

    # one call, kernels vs plain versions on the card
    ev = frames[1]
    plain = make_raw_inference_step(model, cfg, plain=True)
    got, ref = step(states, *ev, is_first), plain(states, *ev, is_first)
    for i, ((hg, cg), (hr, cr)) in enumerate(zip(got[0], ref[0])):
        compare(f"raw stage {i + 1} h vs plain", hg, hr, 5e-2, 2e-2, 5e-3)
        compare(f"raw stage {i + 1} c vs plain", cg, cr, 1e-1, 2e-2, 5e-3)
    with torch.inference_mode():
        fk = event_frames(*ev, cfg)
        if not torch.equal(fk, event_frames(*ev, cfg, plain=True)):
            fail("raw path: histogram differs from the plain version")
        params = backbone_kernel_params(model)
        st = reset_states(states, is_first)
        pg, _ = model(fk, st, params)
        pr, _ = model(fk, st, params, plain=True)
    scale = max(float(pr.abs().max()), 1.0)
    diff = (pg - pr).abs()
    log(f"  raw head outputs vs plain: max|err| {float(diff.max()):.3e} "
        f"mean|err| {float(diff.mean()):.3e} (tolerance max 0.05*"
        f"{scale:.1f}, mean 5e-3*{scale:.1f})")
    if float(diff.max()) > 0.05 * scale or float(diff.mean()) > 5e-3 * scale:
        fail("raw head outputs disagree with the plain versions")

    time_fused_stage(cfg, params)
    raw_breakdown(model, cfg, params, states, ev, is_first)
    profile_window(lambda: step(states, *ev, is_first), "raw call")
    fps = BATCH * RAW_CALLS / dt
    flops = detector_flops_per_frame(cfg.model)["total"]
    mfu = 100.0 * fps * flops / PEAK_BF16_FLOPS
    log(f"raw step: {fps:.1f} frames/s, {1e3 / fps:.4f} ms per batch-frame "
        f"({1e3 * dt / RAW_CALLS:.3f} ms per call of {BATCH} frames), "
        f"{fps * flops / 1e12:.2f} TFLOP/s, MFU {mfu:.2f}% of "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16")
    return fps, mfu, counts_by


def raw_breakdown(model, cfg, params, states, ev, is_first, reps=5):
    """Wall time of each part of a raw call, the card synchronised after
    each part (host clock, mean of ``reps`` calls): where the call's time
    goes when the host issues every operation."""
    import torch

    from rvt_tpu_torch.inference import event_frames
    from rvt_tpu_torch.ops.boxes import postprocess
    from rvt_tpu_torch.training.step import reset_states

    pp = cfg.model.postprocess
    parts = dict(voxelize=0.0, backbone=0.0, fpn_head=0.0, nms=0.0)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] += (time.perf_counter() - t0) * 1e3 / reps
        return out

    torch.cuda.synchronize()
    with torch.inference_mode():
        for _ in range(reps):
            frames = timed("voxelize", lambda: event_frames(*ev, cfg))
            feats, _ = timed("backbone", lambda: model.forward_backbone(
                frames, reset_states(states, is_first), params))
            preds = timed("fpn_head", lambda: model.forward_detect(
                [feats[s] for s in cfg.model.fpn.in_stages]))
            timed("nms", lambda: postprocess(
                torch.cat([preds[..., :4], torch.sigmoid(preds[..., 4:])],
                          -1), cfg.model.head.num_classes,
                pp.confidence_threshold, pp.nms_threshold, pp.pre_nms_topk,
                pp.max_detections))
    log("raw call by part (synchronised after each): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()))


def time_fused_stage(cfg, params):
    """Each stage's ``fused_stage`` (K1-K3 over the B frames, K4 at T = 1)
    at the raw path's shapes, against its plain version: error, ms and the
    least time the card could take for the stage."""
    import torch

    from rvt_tpu_torch.ops import fused_scan as fs

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


def profile_window(fn, what, top=14):
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    and the device's idle share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): an operator's own entry
    # repeats the time of the kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile of one {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}")
    for key, us, n in rows[:top]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / max(busy, 1):5.1f}%  "
            f"x{n:<4d} {key[:90]}")
    host = [(e.key, e.self_cpu_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host.sort(key=lambda r: -r[1])
    log(f"  host: {sum(r[1] for r in host) / 1e3:.2f} ms in operators "
        f"(profiled, so inflated); largest:")
    for key, us, n in host[:8]:
        log(f"  {us / 1e3:9.3f} ms host  x{n:<4d} {key[:90]}")


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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    recs = check_kernels()
    recs["stacked_histogram"] = check_voxelizer()
    fps, mfu, counts = run_main_path()
    raw_fps, raw_mfu, raw_counts = run_raw_path()
    for name, rec in recs.items():
        by_path = {"eval": counts.get(name, 0), "raw": raw_counts[name]}
        rec.d["launches"] = sum(by_path.values())
        rec.d["launches_by_path"] = by_path
    log(f"card: {card}; eval step {fps:.1f} frames/s, MFU {mfu:.2f}%; "
        f"raw step {raw_fps:.1f} frames/s, MFU {raw_mfu:.2f}%")
    print(json.dumps({"kernels": [r.d for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

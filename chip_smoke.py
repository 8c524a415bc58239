#!/usr/bin/env python3
"""Smoke check of the PyTorch port (rvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

  1. report the card (name and power limit, from nvidia-smi);
  2. build the four CUDA kernels from rvt_tpu_torch/csrc (one nvcc per
     source, in parallel) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, at
     every gen1 RVT-B stage shape (T*B = 168 frames): ln_rows on bf16 and
     f32 rows, gemm_bf16 with each epilogue at the qkv/proj/fc1/fc2
     shapes, partition_attention in window and grid mode, lstm_scan at
     T = 21 and at T = 1. Prints the error beside its tolerance and the
     kernel's, plain version's and one library call's times (CUDA
     events), with the least time the card could take (bound);
  4. run the port's RVT-B gen1 streaming eval step (bf16, s2d stem,
     B = 8, T = 21, labels on every 5th frame, pre_nms_topk 512) over
     several windows with the LSTM states carried, random weights from a
     seed; check that every kernel's launch count rose, that the
     detections are finite, and that one window agrees with the same
     step run through the plain versions; print frames/s and MFU;
  5. print the kernels line, then the device line last.

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
BATCH, SEQ_LEN, LABEL_EVERY, WINDOWS = 8, 21, 5, 4
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
    one eval step (count x per-launch time), the largest error seen."""

    def __init__(self, name, source, replaces):
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
            f"{count} per eval step")
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

    profile_window(step, out.states, ev, frame_valid, is_first)
    fps = BATCH * SEQ_LEN * (WINDOWS - 1) / dt
    flops = detector_flops_per_frame(cfg.model)["total"]
    mfu = 100.0 * fps * flops / PEAK_BF16_FLOPS
    log(f"eval step: {fps:.1f} frames/s, {fps * flops / 1e12:.2f} TFLOP/s, "
        f"MFU {mfu:.2f}% of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16")
    return fps, mfu, counts


def profile_window(step, states, ev, frame_valid, is_first, top=14):
    """Device time of one window by kernel name (torch.profiler), and the
    device's idle share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(states, ev, frame_valid, is_first)
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
    log(f"profile of one window: wall {wall_us / 1e3:.2f} ms, device busy "
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
    fps, mfu, counts = run_main_path()
    for name, n in counts.items():
        recs[name].d["launches"] = n
    log(f"card: {card}; eval step {fps:.1f} frames/s, MFU {mfu:.2f}%")
    print(json.dumps({"kernels": [r.d for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

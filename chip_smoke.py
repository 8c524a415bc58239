#!/usr/bin/env python3
"""Smoke check of the PyTorch port (rvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

  1. report the card (name and power limit, from nvidia-smi);
  2. build the CUDA kernels from rvt_tpu_torch/csrc (one nvcc per source,
     all in parallel) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, at
     every gen1 RVT-B stage shape (T*B = 168 frames): ln_rows on bf16 rows
     with their f32 copy (the downsample LN as the paths run it) and on
     f32 rows, printing its lane plan, gemm_bf16 with each epilogue at
     the qkv/proj/fc1/fc2
     shapes, partition_attention in window and grid mode, lstm_scan at
     T = 21 and at T = 1; and stacked_histogram with zero error on gen1
     events (8 x 32768 over 240x304), on gen4 events retargeted into the
     360x640 half grid, on a lane whose events all hit one pixel, on a
     lane with out-of-range and past-counts events, on t out of order,
     100,000 events in one bin, N = 0, counts = 0 and a total that is not
     a multiple of 16, with its event and device time at gen1, gen4 ds2
     and the clustered lane beside each bound and its launches a call;
     and nms_keep (NMS's keep mask, the kernel that lets the steps be
     captured) with keep masks identical to its plain version's on the
     eval and raw steps' calls, on 48 dense frames of 1,680 anchors with
     577-676 candidates (class-aware and class-agnostic), a chain of 1,024
     candidates of depth 1,024, boxes exactly at the IoU threshold, and 0
     and 1 candidates, timed beside its bound; and window_s2d (the eval
     window's layout: the stored uint8 window to the s2d stem's bf16
     operand) identical to its plain version on the stored window's
     channel-last view at B = 8, T = 21, at B = 1, T = 1, on a contiguous
     window and at a gen4-like 360x640, timed beside its bound; and
     bn_act (train-mode BatchNorm + activation of the neck and head,
     forward and backward) against its plain version on every BaseConv
     call of gen1 RVT-B's, RVT-S's and gen4 RVT-B's neck and head at the
     train cells' 48 gathered frames (their layouts and gradients), the
     same bits on a second run, each call shape timed (device time of a
     CUDA graph of 10 calls) beside its bound, the plain version and the
     PyTorch autograd chain it replaced, with each preset's sum a step.
     Prints the error
     beside its tolerance and the kernel's, plain version's and one
     library call's times (CUDA events; K4's yardstick cuDNN's
     ``nn.LSTM``, ``nn.LSTMCell`` at T = 1), with the least time the card
     could take (bound), the kernel's TFLOP/s and its share of the bound;
     for ln_rows, train_reduce and stacked_histogram also the device time
     of a CUDA graph of 10 calls (no host time between launches);
     K4 timed as whole ``fused_lstm_scan`` calls (the input product, the
     bf16 cast and the recurrent kernel, all counted as K4's launches);
     then K2 (every epilogue) and K6 at ragged shapes (M in 1, 127, 129,
     1000, 17000; K, N in 8, 40, 48), K3 and K4 at the other presets'
     geometries (partitions (8, 10), (6, 10), (2, 3), dh 24, 32, 64;
     C 48, 96, 512 at T = 21 and 1, ragged rows), and the training
     kernels the small presets reach (K5 at C 48-384, K7 at dh 24 and 32
     on the three partitions, K8 at C 48-384, T = 21 and 1), correctness
     only;
  4. run the port's RVT-B gen1 streaming eval step (bf16, s2d stem,
     B = 8, T = 21, labels on every 5th frame, pre_nms_topk 512; the
     window fed as the stored buffer's channel-last view, so the step
     runs window_s2d as the validation loop does) over
     several windows with the LSTM states carried, random weights from a
     seed (each step here and below as the port runs it on a card: its
     first call eager, then captured as a CUDA graph and replayed, each
     replay crediting the kernels' counters with its capture's launches);
     check that every kernel's launch count rose, that the
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
  6. hold each training kernel against its plain version at every gen1
     RVT-B stage shape (T*B = 168 frames), forward and backward: K2's
     train epilogues, K4 with c_seq, K5 ln_rows_bwd, K6 gemm_bf16_wgrad,
     K7 partition_attention_bwd, K8 lstm_scan_bwd and train_reduce (one
     launch each for the LayerScale backward and the qkv-bias sums; its
     in-order sums timed at every shape of partials the step gives it,
     each with its launch plan); K6, K2's gelu-backward column sums and
     the three train_reduce functions bit for bit across two runs;
     time each (kernel, plain, library yardstick: K7's SDPA's backward,
     K8's the cuDNN LSTM's backward) beside its bound and its calls per
     train step, K8 as the whole composition its counter counts (pack,
     the gates' and dx's K2 products, the reverse scan); K1 and K3 count
     again for the train step;
  7. run the port's RVT-B gen1 TBPTT train step (bf16, no s2d stem, B = 8,
     T = 21, K = 6, M = 48, labels on every 5th frame, random weights from
     seed 0) for 1 + 5 steps with the states carried; check that every
     kernel of the path was launched; print ms per step, frames/s, train
     MFU and peak memory; profile one step; hold one step against the
     same step on the plain versions from identical model, BatchNorm
     buffers, optimizer and states, the kernel step's head fed the plain
     step's features with the kernel backbone's gradient (features, loss
     parts, each gradient leaf, grad_norm, final states, buffers);
  8. run the per-step train backbone (``fused_train_scan_backbone(
     per_step=True)``: row 7, ``fused_stage_step_train``, at every stage
     and time step) over the train cell's window with the states carried,
     one forward and backward under a fixed linear loss; check that every
     kernel was launched and row 7 once per stage and step; hold it
     against the whole-window path (forward bit for bit, each gradient
     leaf within 2e-2 of its max|ref|) and against its plain versions
     (features and states as phase 7, each leaf within 5e-2); time every
     kernel at the per-step shapes and row 7 per call at each stage;
  9. run the Trainer at gen1 RVT-B with token masking (4 batches of the
     train cell's shape, masks of ~20 % of the stage-1 tokens; logging
     every step, checkpoints at 2 and 4 published to an artifact registry,
     the gradflow and detection variants on their cadences), then a fresh
     Trainer's ``restore()`` and another's ``restore_from_artifact``, each
     held bit for bit and taking one more finite step; print ms per step
     and frames/s;
 10. run one gen1 RVT-S train step (``preset("gen1", "small")``: C 48,
     96, 192, 384, dh 24; B = 8, T = 21) on the kernels after a warm-up
     step; check that every kernel was launched (K5, K7 and K8 at the
     small preset's widths) and hold the step against the plain step as
     phase 7 does, at phase 7's tolerances;
 12. (run after phase 10) ``preset("gen1", "base")`` as shipped
     (fused_kernels off, f32: the module path at RVT-B's full widths, no
     kernel launched): the eval step at B = 8, T = 21 over 2 windows
     (frames/s, the idle share of a profiled window), a per-step forward
     over one window against the window scan bit for bit, two carried
     train steps (ms per step, peak memory); then the module path on the
     card against the same path on the CPU at gen1 tiny (64, 80), T = 2,
     f32 (states and head outputs within 1e-4 of max|ref|);
 13. (run after phase 12) the validation path: ``run_streaming_eval``
     over ``EvalStreamScheduler`` windows (B = 8, T = 21) of ten
     in-memory recordings of 40-100 frames (uint8 histograms from a numpy
     seed, three 32x32 boxes on every 5th frame; lanes that restart
     mid-run, padded fill windows): on the kernels config that
     ``cli.validate --serve_fused`` builds (gen1 RVT-B, bf16, s2d stem)
     with phase 4's weights at confidence threshold 1e-4 (NMS sees
     candidates), K1-K4, nms_keep and window_s2d launched the eval
     step's count per window x
     windows, six finite stats, equal bit for bit to the same windows fed
     by hand (make_eval_step, the pinned feed, iter_batch_detections,
     PropheseeEvaluator), each part of a window timed (read+stack, the
     pinned copy, the channel-last view, eval step, output wait,
     conversion; postprocess alone on nms_keep and on the plain route,
     identical detections, with its candidates and the plain route's
     Jacobi rounds; the protocol at the end), the idle share of a
     profiled window, loop
     frames/s; the model saved as an upstream Lightning .ckpt and loaded
     by ``cli.validate.load_model``, the same metrics bit for bit; the
     Trainer (gen1 RVT-B on the train kernels, 2 steps) validating every
     step over the same windows, with train panels: each validation's
     detections and metrics equal to a fresh loop's on its step's
     weights, the two steps' detections different, the best slot
     restored by ``load_model`` to its metrics bit for bit; the shipped
     preset's loop (f32, modules) over 1 timed window; the loop at gen1
     tiny (64, 80), T = 5, f32 on the card against the CPU: detections
     frame by frame (counts equal, boxes and scores within 1e-4 of
     max|ref|) and the six stats within 1e-4;
 14. (run after phase 13) training from recordings through the training
     CLI's functions (``cli/train.py``: ``build_train_scheduler``,
     ``make_eval_fn``, ``--init_ckpt``'s ``load_torch_checkpoint``) over
     ten in-memory recordings as phase 13 makes them (7 train, 3 val):
     whether ``native_lib`` loads here (its COCO matcher then against the
     numpy one); the mixed sampler at gen1, B = 8, T = 21 (4 stream and
     4 random lanes, augmentation on), 6 batches bit for bit serially and
     through 2 thread workers, the random lanes reset every batch, a
     window flipped and one zoomed, the loader's frames/s both ways;
     ``preset("gen1", "base")`` as the CLI trains it (fused_kernels off,
     the compute dtype from training.precision) after an upstream .ckpt
     loaded bit for bit, 3 steps with validation at step 2 and
     checkpoints at 2 and 3; the train kernels config for 2 steps (K1-K8
     and train_reduce launched: the "train cli" launches); each timed a
     step fed by the scheduler (prefetch on) and by the same batches
     stacked beforehand, the kernels also through 2 thread workers; the
     serial loader's batch by part (the Trainer's pinned feed among
     them); the CLI's first step on the card
     against the CPU at gen1 tiny, f32, B = 2, T = 5 (loss parts and
     grad_norm within 1e-4 of their magnitude);
 15. (run after phase 14) each path's step captured against the same
     step eager from the same state, in one run: the eval step (4
     windows), the raw step (1 + 21 calls), the train step (1 + 5 steps;
     the parameters, BatchNorm buffers, gradients and moments after),
     the per-step backbone's forward and backward (3 calls) and the
     Trainer with token masks (4 batches; its state after), every output
     and state bit for bit (cuDNN's deterministic algorithms); one replay
     of each under ``torch.cuda.set_sync_debug_mode("error")``; ms a
     call, frames/s, device busy time and idle share of a profiled call
     and peak memory, captured beside eager;
 16. (run after phase 15) data parallelism (``rvt_tpu_torch/parallel/``)
     on the train cell (gen1 RVT-B, the train kernels, B = 8, T = 21):
     (a) one rank over NCCL in this process, the dp train step captured,
     bit for bit with the same step without a group over 4 steps (both
     variants the Trainer runs), timed beside it (ms a step, busy, idle,
     the NCCL kernels' share); (b) two ranks sharing the card over gloo
     (eager), 4 lanes each of the global batch: replicas and the
     ranks' metrics bit for bit after every step; against (a)'s step on
     the global batch, step 1's loss parts and grad_norm (0.1 relative:
     SimOTA's picks differ between processes) and the BatchNorm buffers
     after it (2e-2 of max|ref|), the gradient leaves and the later
     steps' drift printed beside one process's spread with its lanes
     rotated; an f32 leg (the shipped preset, TF32 off, 3 steps) held at
     the f32 tests' tolerances every step, gradient leaves included; (c)
     ``run_streaming_eval`` on two shards of phase 13's recordings:
     merged metrics the same on both ranks, bit for bit those of one
     process scoring the shards' frames in rank order, within 1e-4 of
     one process over all recordings; (d) a two-rank ``Trainer.fit``,
     each checkpoint and publish written once; (e)
     ``dryrun_multichip(2)``; (f) with two cards or more, NCCL ranks one
     a card, two and every card, 9 steps captured and the same 9 eager
     (``graphs.eager()``): the replays bit for bit with the eager calls
     on every step, the captured ranks and the f32 leg held as (b), timed
     (``run_multi_card_leg``; else a line saying why not). Ranks are
     processes of ``rvt_tpu_torch.parallel.dryrun`` running this
     script's ``dp_*`` scenarios, joined with a timeout, in a temporary
     directory removed after; the dp step's launches a rank are the
     kernels line's "dp, per rank";
 11. check that the calls each kernel was timed at per step are the
     launches its paths made per step; print the kernels line (per
     kernel: launches by path, the validation loop's and the train CLI's
     among them, and ms, plain, bound and library summed over one step
     of each path it serves, and by path), after one line
     per K4 and per K8 call shape (path, stage, launches, ms beside
     cuDNN's LSTM forward or backward, and the launch plan of the
     recurrent kernel), then the device line last.

It imports nothing of JAX. It exits 2 without a CUDA device or without
the rvt_tpu_torch package beside it.
"""
from __future__ import annotations

import contextlib
import itertools
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
TRAIN_STEPS = 5
STEP_SEQ_LEN = SEQ_LEN  # the per-step backbone's window (phase 8)
EVENTS, RAW_FRAMES, RAW_CALLS = 32768, 4, 21
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
    (eval step, raw step, train step) it sums count x per-launch time over
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
            path.items() if isinstance(path, dict) else ((path, 1),))}
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
    for si, (H, W, C) in enumerate(STAGES):
        M = n_frames * H * W
        log(f"stage {H}x{W}x{C}: {n_frames} frames, {M} rows")
        s, b = randn(C, scale=0.2) + 1.0, randn(C, scale=0.2)
        # K1: the ds-LN reads the bf16 conv output, LN1/LN2 the f32
        # residual; the train step runs each twice (forward, recompute)
        for dtype, count in ((torch.bfloat16, 1), (torch.float32, 3)):
            # the trainer's stage 1 takes a normed, masked input: no ds-LN
            masked = si == 0 and dtype == torch.bfloat16
            err, ms, pms, lms, nbytes, dms = ln_rows_case(fa, randn, s, b,
                                                          M, C, dtype)
            recs["ln_rows"].add(
                {"eval step": count, "train step": 2 * count,
                 "trainer": 0 if masked else 2 * count}, 1, err, ms, pms,
                nbytes, 8 * M * C, PEAK_F32_FLOPS, lms, device_ms=dms)
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
            err = compare(f"gemm_bf16[{label} {epi}]", got, ref, 3.2e-2,
                          1e-2)
            R1 = R0.clone() if R0 is not None else None
            ms = time_ms(lambda: fa.gemm_bf16(a, w, epi, bias=bias, out=R1))
            pms = time_ms(lambda: fa.gemm_bf16(a, w, epi, bias=bias, out=R1,
                                               plain=True))
            lms = time_ms(lambda: torch.matmul(a, w))
            out_bytes = M * N * (8 if epi == "residual" else 2)
            recs["gemm_bf16"].add("eval step", 2, err, ms, pms,
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
            # the train step: the forward and the backward's recompute
            recs["partition_attention"].add(
                {"eval step": 1, "train step": 2, "trainer": 2}, 1, err, ms,
                pms, M * 4 * C * 2,
                4 * n_frames * parts * heads * n_tok * n_tok * DIM_HEAD,
                PEAK_BF16_FLOPS, lms)
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
    plain versions at phase 3's and phase 6's tolerances; K6 and the gelu
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
    against their plain versions at phase 6's tolerances: K5 at C 48-384
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


def eval_cell():
    """Phase 4's cell: (cfg, model, a window on the card as the feed hands
    it over, the stored [B, T, C, H, W] uint8 buffer's channel-last view,
    frame_valid, is_first). The step blocks and casts it itself
    (``ops/s2d.py:window_s2d``)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.detector import init_detector
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
    rng = np.random.RandomState(0)
    ev_raw = rng.randint(0, 8, size=(BATCH, SEQ_LEN, 240, 304, 20)
                         ).astype(np.uint8)
    ev = torch.from_numpy(np.ascontiguousarray(
        ev_raw.transpose(0, 1, 4, 2, 3))).cuda().permute(0, 1, 3, 4, 2)
    frame_valid = torch.from_numpy(
        (np.arange(SEQ_LEN) % LABEL_EVERY == LABEL_EVERY - 1)[None].repeat(
            BATCH, 0)).cuda()
    is_first = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    return cfg, model, ev, frame_valid, is_first


def run_main_path():
    """Phase 4. Returns (frames/s, MFU %, launch counts by kernel)."""
    import numpy as np
    import torch

    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.ops.boxes import NMS_KEEP
    from rvt_tpu_torch.ops.fused_attention import (GEMM_BF16, LN_ROWS,
                                                   PARTITION_ATTENTION)
    from rvt_tpu_torch.ops.fused_scan import LSTM_SCAN
    from rvt_tpu_torch.ops.s2d import WINDOW_S2D
    from rvt_tpu_torch.training.step import make_eval_step
    from rvt_tpu_torch.utils.flops import detector_flops_per_frame

    cfg, model, ev, frame_valid, is_first = eval_cell()
    states = zero_states(cfg.model.backbone, BATCH, device="cuda")
    step = make_eval_step(model, cfg)
    counters = (LN_ROWS, GEMM_BF16, PARTITION_ATTENTION, LSTM_SCAN, NMS_KEEP,
                WINDOW_S2D)

    for c in counters:
        c.reset()
    # first window: the warm-up (eager), then the capture; then replays
    out = step(states, ev, frame_valid, is_first)
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
    class-aware and class-agnostic (the validation loop's load; phase 13
    holds the random head's own frames); a frame of 1,024 candidates in a
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


def raw_cell():
    """Phase 5's cell: (cfg, model, RAW_FRAMES distinct event frames made
    on the card, is_first)."""
    from dataclasses import replace

    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.detector import init_detector

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
    return cfg, model, frames, torch.zeros(BATCH, dtype=torch.bool,
                                           device="cuda")


def run_raw_path():
    """Phase 5. Returns (frames/s, MFU %, launch counts by kernel)."""
    import torch

    from rvt_tpu_torch.inference import event_frames, make_raw_inference_step
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import backbone_kernel_params
    from rvt_tpu_torch.ops import fused_scan as fs
    from rvt_tpu_torch.ops.boxes import NMS_KEEP
    from rvt_tpu_torch.ops.fused_attention import (GEMM_BF16, LN_ROWS,
                                                   PARTITION_ATTENTION)
    from rvt_tpu_torch.ops.voxelization import STACKED_HISTOGRAM
    from rvt_tpu_torch.training.step import reset_states
    from rvt_tpu_torch.utils.flops import detector_flops_per_frame

    cfg, model, frames, is_first = raw_cell()
    states = zero_states(cfg.model.backbone, BATCH, device="cuda")
    step = make_raw_inference_step(model, cfg)
    counters = (LN_ROWS, GEMM_BF16, PARTITION_ATTENTION, fs.LSTM_SCAN,
                STACKED_HISTOGRAM, NMS_KEEP)

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


MASKED_PATHS = ("trainer",)  # stage 1's input arrives normed: no ds-LN


def check_fwd_kernels(recs, paths, paths_ds, g, n_frames, H, W, C):
    """K1 and K3 of a train path's forward and recompute at n_frames
    frames of one stage, against their plain versions, with their calls
    per step of ``paths`` (``paths_ds`` for the downsample LN)."""
    import torch
    import torch.nn.functional as F

    from rvt_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    M = n_frames * H * W
    s, b = randn(C, scale=0.2) + 1.0, randn(C, scale=0.2)
    # the ds-LN (bf16 in) and LN1, LN2 x 2 (f32), forward and recompute
    for dtype, count, where in ((torch.bfloat16, 2, paths_ds),
                                (torch.float32, 6, paths)):
        err, ms, pms, lms, nbytes, dms = ln_rows_case(fa, randn, s, b, M, C,
                                                      dtype)
        recs["ln_rows"].add(where, count, err, ms, pms, nbytes, 8 * M * C,
                            PEAK_F32_FLOPS, lms, device_ms=dms)
    heads, n_tok = C // DIM_HEAD, PART[0] * PART[1]
    parts = (H // PART[0]) * (W // PART[1])
    qkv = randn(n_frames, H, W, 3 * C)
    q, k, v = [randn(n_frames * parts, heads, n_tok, DIM_HEAD)
               for _ in range(3)]
    for window in (True, False):
        kw = dict(heads=heads, dim_head=DIM_HEAD, part=PART, window=window)
        err = compare(f"partition_attention[{'window' if window else 'grid'}]",
                      fa.partition_attention(qkv, **kw),
                      fa.partition_attention_plain(qkv, heads, DIM_HEAD, PART,
                                                   window), 3.2e-2, 1e-2)
        ms = time_ms(lambda: fa.partition_attention(qkv, **kw))
        pms = time_ms(lambda: fa.partition_attention_plain(
            qkv, heads, DIM_HEAD, PART, window))
        lms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        recs["partition_attention"].add(
            paths, 2, err, ms, pms, M * 4 * C * 2,
            4 * n_frames * parts * heads * n_tok * n_tok * DIM_HEAD,
            PEAK_BF16_FLOPS, lms)


def check_train_kernels(recs, frames=SEQ_LEN * BATCH, steps=SEQ_LEN,
                        paths=None, with_fwd=False):
    """Phase 6: the training kernels at the train step's shapes (the pair
    over T*B frames, the LSTM over B lanes and T steps), added to ``recs``
    (new entries for the new kernels) with their calls per train step and
    per trainer step (stage 1 masked). Phase 8 calls it again at the
    per-step path's shapes (the pair over B frames, the LSTM at T = 1,
    SEQ_LEN times per window) with ``with_fwd``: K1 and K3, which phase 3
    times at the whole-window shapes, timed here too. ``paths``: {path:
    calls per step of that path per call counted here}."""
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
    TS = paths or {"train step": 1, "trainer": 1}
    per = next(iter(TS))  # the path the sum_parts summary line counts

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def first(x):
        return x[0] if isinstance(x, tuple) else x

    def plan(what, M, N, itemsize=4):
        p = fa.reduce_plan(M, N, itemsize)
        log(f"  train_reduce plan, {what} [{M}, {N}]: {p.chunks} row chunks "
            f"of {p.rows}, {p.blocks(N)} blocks of {p.tx} x {p.ty} threads, "
            f"{p.vec} columns a thread")

    def sum_parts(label, part, count, where=None):
        """``train_reduce``'s in-order sum at partials the path gives it;
        plain = torch's sum over the same partials."""
        plan(f"sum_parts {label}", part.shape[0], part[0].numel())
        err = compare_rel(f"sum_parts[{label} {list(part.shape)}]",
                          fa.sum_parts(part), part.sum(0), 1e-5)
        ms = time_ms(lambda: fa.sum_parts(part))
        dms = device_ms_of(lambda: fa.sum_parts(part))
        pms = time_ms(lambda: fa.sum_parts(part, plain=True))
        lms = time_ms(lambda: torch.sum(part, 0))
        recs["train_reduce"].add(where or TS, count, err, ms, pms,
                                 4 * (part.numel() + part[0].numel()),
                                 part.numel(), PEAK_F32_FLOPS, lms,
                                 device_ms=dms)
        n = count * (where or TS)[per]
        for k, v in zip(sp, (n, n * ms, n * pms, n * lms, n * dms)):
            sp[k] += v

    T, B, n_frames = steps, BATCH, frames
    sms = sm_count(torch.empty(1, device=dev))
    sp = dict(calls=0, ms=0.0, plain_ms=0.0, library_ms=0.0, device_ms=0.0)
    for si, (H, W, C) in enumerate(STAGES):
        M = n_frames * H * W
        rpb = fa._rows_per_block(M)
        log(f"train stage {H}x{W}x{C}: {n_frames} frames, {M} rows")
        # the counts of the downsample LN's kernels (none on a masked
        # path's stage 1)
        TSm = {p: 0 if si == 0 and p in MASKED_PATHS else n
               for p, n in TS.items()}
        if with_fwd:
            check_fwd_kernels(recs, TS, TSm, g, n_frames, H, W, C)
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
            err = compare(f"gemm_bf16[{label} {epi}]", first(got),
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
                TS if add else TSm, count, err, ms, pms,
                M * C * (x.element_size() + 4 + (8 if add else 2)),
                20 * M * C, PEAK_F32_FLOPS, lms)
        sum_parts("ln_rows_bwd ds/db", randn(-(-M // rpb), 2, C, dtype=f32),
                  1, {p: n * (3 if TSm[p] == 0 else 4)
                      for p, n in TS.items()})
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
        # the per-step path (T = 1) keeps K4's weight layout for a window
        wt = fs.lstm_weights_t(w) if T == 1 else None
        fwd = fs.fused_lstm_scan(x, w, bias, h0, c0, with_c_seq=True,
                                 lstm_wt=wt)
        ref4 = fs.fused_lstm_scan(x, w, bias, h0, c0, with_c_seq=True,
                                  plain=True)
        err = 0.0
        for nm, gt, rf, tol in zip(("h_seq", "c_seq", "h_T", "c_T"), fwd,
                                   ref4, (2e-2, 5e-2, 2e-2, 5e-2)):
            err = max(err, compare(f"lstm_scan[c_seq] {nm}", gt, rf, tol,
                                   2e-2, 2e-3))
        ms = time_ms(lambda: fs.fused_lstm_scan(x, w, bias, h0, c0,
                                                with_c_seq=True, lstm_wt=wt))
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
        K4_STAGES.append((per, f"{H}x{W}x{C}", T, P, launches, ms, lms))
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
        K8_STAGES.append((per, f"{H}x{W}x{C}", T, P, launches, ms, lms,
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
    log(f"sum_parts of K2's gelu backward, K5, K6 and K8, per {per}: "
        f"{sp['calls']} calls, kernel {sp['ms']:.4f} ms (device "
        f"{sp['device_ms']:.4f} ms), plain {sp['plain_ms']:.4f} ms, "
        f"torch.sum {sp['library_ms']:.4f} ms")


def train_arrays(cfg, B=BATCH, T=SEQ_LEN):
    """The profile_train.py batch as numpy arrays: uint8 events in [0, 8)
    of [B, T, H, W, 20] at the dataset's resolution from numpy seed 0;
    three boxes on every 5th frame; no lane restarting."""
    import numpy as np

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
    return ev, labels, label_mask, label_mask.any(-1), np.zeros(B, bool)


def train_batch(cfg, device):
    """``train_arrays`` on ``device``."""
    import torch

    return tuple(torch.from_numpy(a).to(device) for a in train_arrays(cfg))


def run_train_path():
    """Phase 7. Returns (ms per step, frames/s, train MFU %, peak GB,
    launch counts by kernel)."""
    from dataclasses import replace

    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.ops import bn_act
    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.ops import fused_scan as fs
    from rvt_tpu_torch.training.step import init_train_state, make_train_step
    from rvt_tpu_torch.utils.flops import detector_flops_per_frame

    cfg = preset("gen1", "base")
    cfg = replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True)))
    bb = cfg.model.backbone
    if bb.stem_s2d or bb.enable_masking:
        fail("the train cell runs without the s2d stem and token masks")
    model, opt = init_train_state(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():  # LayerScale gammas as the earlier phases draw them
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
    batch = train_batch(cfg, "cuda")
    states = zero_states(bb, BATCH, device="cuda")
    step = make_train_step(model, cfg, opt)
    counters = (fa.LN_ROWS, fa.PARTITION_ATTENTION, fs.LSTM_SCAN,
                fa.GEMM_BF16, fa.LN_ROWS_BWD, fa.GEMM_BF16_WGRAD,
                fa.PARTITION_ATTENTION_BWD, fs.LSTM_SCAN_BWD,
                fa.TRAIN_REDUCE, bn_act.BN_ACT)

    for c in counters:
        c.reset()
    states, m = step(states, *batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        states, m = step(states, *batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = {c.name: c.launches for c in counters}
    log(f"train path: 1 + {TRAIN_STEPS} steps, launches {counts}")
    for name, n in counts.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the train path")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: float(v) for k, v in m.items()}
    log(f"train metrics (step {1 + TRAIN_STEPS}): {metrics}")
    if not all(math.isfinite(v) for v in metrics.values()) or loss <= 0:
        fail("train step: non-finite or non-positive loss")

    fl = detector_flops_per_frame(cfg.model)
    K = cfg.dataset.max_labeled_frames
    step_flops = 3 * (fl["backbone"] * BATCH * SEQ_LEN
                      + (fl["fpn"] + fl["head"]) * BATCH * K)
    mfu = 100.0 * step_flops / dt / PEAK_BF16_FLOPS
    fps = BATCH * SEQ_LEN / dt
    log(f"train step: {dt * 1e3:.2f} ms per step, {fps:.1f} frames/s, "
        f"train MFU {mfu:.2f}% ({step_flops / 1e12:.3f} TFLOP per step over "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16), peak memory "
        f"{peak:.2f} GiB")
    log("launches per train step: " + ", ".join(
        f"{k} {v // (1 + TRAIN_STEPS)}" for k, v in counts.items()))
    profile_window(lambda: step(states, *batch), "train step", top=40)

    hold_train_step_vs_plain(model, opt, cfg, states, batch, step, "train")
    return dt * 1e3, fps, mfu, peak, counts


def run_small_train_path():
    """Phase 10: one gen1 RVT-S train step (``preset("gen1", "small")``:
    stages of C 48, 96, 192, 384, dh 24; bf16, the train kernels, B = 8,
    T = 21, random weights from seed 0) on the kernels after one warm-up
    step; check that every kernel was launched, K5 at C 48-384, K7 at dh
    24 and K8 at C = 96 among them; then hold one step against the same
    step on the plain versions as phase 7 does, at phase 7's tolerances.
    Returns (ms per step, launch counts of one step)."""
    from dataclasses import replace

    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.training.step import init_train_state, make_train_step

    cfg = preset("gen1", "small")
    cfg = replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True)))
    bb = cfg.model.backbone
    log(f"gen1 RVT-S: stage widths {bb.stage_dims}, dim_head "
        f"{bb.attention.dim_head}")
    model, opt = init_train_state(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():  # LayerScale gammas as phase 7 draws them
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
    batch = train_batch(cfg, "cuda")
    states = zero_states(bb, BATCH, device="cuda")
    step = make_train_step(model, cfg, opt)
    states, _ = step(states, *batch)  # warm-up: launch plans, allocator
    counters = stage_step_counters()[:-1]
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, m = step(states, *batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {c.name: c.launches for c in counters}
    log(f"small train step: {ms:.2f} ms, launches {counts}")
    for name, n in counts.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the gen1 RVT-S step")
    metrics = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        fail("gen1 RVT-S train step: non-finite metrics")
    hold_train_step_vs_plain(model, opt, cfg, states, batch, step,
                             "small train")
    del model, opt, states
    torch.cuda.empty_cache()
    return ms, counts


def hold_train_step_vs_plain(model, opt, cfg, states, batch, step, label):
    """Phase 7's check (and phase 10's): one step on the plain versions,
    then the same step on the kernels, from identical model, BatchNorm
    buffers, optimizer and states, the kernel step's head fed the plain
    step's features with the kernel backbone's gradient; features, loss
    parts, each gradient leaf, grad_norm, final states and buffers held
    at fixed tolerances."""
    import copy

    import torch

    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training import step as step_mod
    from rvt_tpu_torch.training.step import make_train_step

    # one step on the plain versions, then the same step on the kernels,
    # from identical model, BatchNorm buffers, optimizer and states. The
    # kernel step's head is fed the plain step's features (their values,
    # with the kernel backbone's gradient): the FPN/head, BatchNorm,
    # SimOTA and the loss then see identical inputs on both sides, and
    # every gradient leaf and grad_norm differ only by what the backbone's
    # kernels do. Fed its own features, the head amplifies their one-ulp
    # differences with random weights: SimOTA's picks flip, and with the
    # picks held the step's grad_norm still moved by 12 % (H100, this
    # cell) where a 1e-3 move of one stem weight moved it by 4 %.
    # The kernel step runs eagerly: its captured graph would not see the
    # shared features.
    pmodel, popt = copy.deepcopy((model, opt))
    kept = {}
    scan = step_mod.scan_backbone
    step_mod.scan_backbone = shared_features(scan, kept)
    try:
        st_p, m_p = make_train_step(pmodel, cfg, popt, plain=True)(states,
                                                                  *batch)
        with graphs.eager():
            st_k, m_k = step(states, *batch)
    finally:
        step_mod.scan_backbone = scan
    for i, (fk, fp) in enumerate(zip(kept["own"], kept["first"])):
        compare(f"{label} features {i + 1} vs plain", fk, fp, 5e-2, 2e-2,
                5e-3)
    for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg"):
        a, b = float(m_k[k]), float(m_p[k])
        tol = 1e-4 * max(abs(b), 1e-3)  # identical inputs; cuDNN's order
        log(f"  {label} {k}: kernels {a:.6g}, plain {b:.6g} (tolerance "
            f"{tol:.3g})")
        if not abs(a - b) <= tol:
            fail(f"{label} step {k} disagrees with the plain versions")

    # each gradient leaf within 5e-2 of its max |ref|; grad_norm within 2 %
    def grads(mdl):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in mdl.parameters()]

    rows = sorted(((compare_rel_quiet(gk, gp), name)
                   for (name, _), gk, gp in zip(
                       model.named_parameters(), grads(model),
                       grads(pmodel))), reverse=True)
    over = [r for r in rows if not r[0] <= 5e-2]
    log(f"  {label} gradients vs plain, {len(rows)} leaves: median "
        f"{rows[len(rows) // 2][0]:.3e} of max|ref|; worst "
        + "; ".join(f"{n} {e:.3e}" for e, n in rows[:5])
        + " (tolerance 5e-2)")
    nk, npl = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    log(f"  {label} grad_norm: kernels {nk:.6g}, plain {npl:.6g} (tolerance "
        "2e-2 x plain)")
    if over or not abs(nk - npl) <= 2e-2 * npl:
        fail(f"{label} gradients disagree with the plain versions "
             f"({len(over)} leaves out of tolerance)")
    for i, ((hk, ck), (hp, cp)) in enumerate(zip(st_k, st_p)):
        compare(f"{label} stage {i + 1} h_T vs plain", hk, hp, 5e-2, 2e-2,
                5e-3)
        compare(f"{label} stage {i + 1} c_T vs plain", ck, cp, 1e-1, 2e-2,
                5e-3)
    bk, bp = dict(model.named_buffers()), dict(pmodel.named_buffers())
    berr = max(compare_rel_quiet(bk[n], bp[n]) for n in bk
               if n.endswith(("running_mean", "running_var")))
    log(f"  BatchNorm buffers vs plain: worst {berr:.3e} of max|ref| "
        "(tolerance 2e-2)")
    if not berr <= 2e-2:
        fail(f"{label}: BatchNorm buffers disagree with the plain versions")
    del pmodel, popt, st_p
    torch.cuda.empty_cache()


def gen1_base_train_cfg(**backbone):
    """The train cell's config: gen1 RVT-B, bf16, the train kernels, no
    s2d stem; ``backbone`` overrides (the trainer's token masking)."""
    from dataclasses import replace

    from rvt_tpu_torch.config import preset

    cfg = preset("gen1", "base")
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True,
                         **backbone)))


def gen1_base_model(cfg, seed=0, device="cuda"):
    """Random weights from ``seed``, LayerScale gammas drawn at 0.1 as the
    earlier phases draw them."""
    import torch

    from rvt_tpu_torch.models.detector import init_detector

    model = init_detector(cfg.model, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
    return model


def stage_step_counters():
    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.ops import fused_scan as fs
    from rvt_tpu_torch.ops import fused_train as ft

    return (fa.LN_ROWS, fa.PARTITION_ATTENTION, fs.LSTM_SCAN, fa.GEMM_BF16,
            fa.LN_ROWS_BWD, fa.GEMM_BF16_WGRAD, fa.PARTITION_ATTENTION_BWD,
            fs.LSTM_SCAN_BWD, fa.TRAIN_REDUCE, ft.STAGE_STEP_TRAIN)


def run_step_backbone_path(recs):
    """Phase 8: the per-step train backbone (``fused_train_scan_backbone(
    per_step=True)``, row 7 at every stage and time step) over the train
    cell's window, states carried, one forward and backward under a fixed
    linear loss on the features and final states. Held against the
    whole-window path (forward bit for bit, each gradient leaf within 2e-2
    of its max|ref|) and against its plain versions (features and states
    as phase 7 holds them, each leaf within 5e-2). Times every kernel at
    the per-step shapes and row 7 per call. Returns the launch counts of
    the one kernel run."""
    import torch

    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import fused_train_scan_backbone
    from rvt_tpu_torch.ops import fused_train as ft
    from rvt_tpu_torch.training.step import pad_ev_repr

    cfg = gen1_base_train_cfg()
    bb = cfg.model.backbone
    model = gen1_base_model(cfg)
    ev = train_batch(cfg, "cuda")[0][:, :STEP_SEQ_LEN]
    ev_seq = pad_ev_repr(ev, bb.in_res_hw, torch.float32).transpose(0, 1)
    T = ev_seq.shape[0]
    with torch.no_grad():  # states carried from one window
        _, states = fused_train_scan_backbone(
            model, ev_seq, zero_states(bb, BATCH, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(6)
    weights = {}
    params = [(n, p) for n, p in model.named_parameters()
              if n.startswith("backbone.")]

    def run(per_step, plain=False):
        model.zero_grad(set_to_none=True)
        feats, final = fused_train_scan_backbone(
            model, ev_seq, states, per_step=per_step, plain=plain)
        outs = list(feats) + [t for hc in final for t in hc]
        if not weights:
            weights["w"] = [torch.randn(o.shape, generator=g, device="cuda")
                            for o in outs]
        loss = sum((o.float() * w).sum() for o, w in zip(outs, weights["w"]))
        loss.backward()
        return ([o.detach() for o in outs],
                [p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p) for _, p in params])

    counters = stage_step_counters()
    for c in counters:
        c.reset()
    got, ggot = run(True)
    torch.cuda.synchronize()
    counts = {c.name: c.launches for c in counters}
    log(f"per-step train backbone: T = {T}, launches {counts}")
    for name, n in counts.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the per-step path")
    if counts[ft.STAGE_STEP_TRAIN.name] != T * len(STAGES):
        fail("the per-step path did not call row 7 once per stage and step")
    ms_step = time_ms(lambda: run(True), 2)
    ms_win = time_ms(lambda: run(False), 2)
    log(f"  backbone forward + backward: per step {ms_step:.2f} ms, whole "
        f"window {ms_win:.2f} ms")
    profile_window(lambda: run(True), "per-step backbone forward and "
                   "backward", top=20)

    def leaves(name, gk, gr, tol):
        rows = sorted(((compare_rel_quiet(a, b), n) for (n, _), a, b in
                       zip(params, gk, gr)), reverse=True)
        median = rows[len(rows) // 2][0]
        log(f"  {name}, {len(rows)} leaves: median {median:.3e} of "
            "max|ref|; worst " + "; ".join(
                f"{n} {e:.3e}" for e, n in rows[:3]) + f" (tolerance {tol})")
        if not rows[0][0] <= tol:
            fail(f"{name}: {sum(e > tol for e, _ in rows)} leaves out of "
                 "tolerance")

    win, gwin = run(False)
    for i, (a, b) in enumerate(zip(got, win)):
        if not torch.equal(a, b):
            fail(f"per-step output {i} differs from the whole-window path")
    log(f"  forward vs whole window: {len(got)} outputs bit for bit")
    leaves("per-step vs whole-window gradients", ggot, gwin, 2e-2)
    del win, gwin
    ref, gref = run(True, plain=True)
    n_f = len(got) - 2 * len(STAGES)
    for i, (a, b) in enumerate(zip(got, ref)):
        if i < n_f:
            compare(f"per-step features {i + 1} vs plain", a, b, 5e-2, 2e-2,
                    5e-3)
        elif (i - n_f) % 2 == 0:
            compare(f"per-step stage {(i - n_f) // 2 + 1} h_T vs plain", a, b,
                    5e-2, 2e-2, 5e-3)
        else:
            compare(f"per-step stage {(i - n_f) // 2 + 1} c_T vs plain", a, b,
                    1e-1, 2e-2, 5e-3)
    leaves("per-step gradients vs plain", ggot, gref, 5e-2)
    del got, ggot, ref, gref, weights["w"]
    torch.cuda.empty_cache()

    # every kernel at the per-step shapes (B frames, T = 1), T calls per
    # stage, and row 7 per call
    paths = {"per-step train": T}
    check_train_kernels(recs, frames=BATCH, steps=1, paths=paths,
                        with_fwd=True)
    recs["fused_stage_step_train"] = time_stage_step_train(model, cfg, T)
    return counts


def time_stage_step_train(model, cfg, T):
    """Row 7 (``fused_stage_step_train``, forward and backward) per call
    at each stage with the model's weights, B frames, against its plain
    version: every output cotangent's gradient within 5e-2 of max|ref|.
    Returns its Record (T calls per stage per per-step step)."""
    import torch

    from rvt_tpu_torch.models.detector import downsample_ln_params
    from rvt_tpu_torch.ops import fused_train as ft

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
        rec.add("per-step train", T, err, ms, pms,
                P * C * (2 * 2 + 8 * 4) + 2 * wbytes,
                3 * P * (2 * (24 * C * C + 4 * tok * C) + 16 * C * C),
                PEAK_BF16_FLOPS, None)
        del x, h, c, dh, dc, prm, leaves
    return rec


def trainer_batches(cfg, n=4, B=BATCH, T=SEQ_LEN, masks=True):
    """``n`` Batches of [B, T] windows at the dataset's resolution (the
    train cell's shape by default) from numpy seed 0: uint8 events in
    [0, 8), three boxes on every 5th frame stamped past the Prophesee
    protocol's 0.5 s warm-up, the first batch restarting every lane, and
    with ``masks`` a token mask of about 20 % True at the stage-1 token
    grid of the sensor, [B, T, 60, 76]."""
    import numpy as np

    from rvt_tpu_torch.data.types import Batch

    H, W = cfg.dataset.dataloading_hw
    M = cfg.dataset.max_labels_per_frame
    ps = cfg.model.backbone.stem_patch_size
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        ev = rng.randint(0, 8, size=(B, T, H, W, 20)).astype(np.uint8)
        labels = np.zeros((B, T, M, 7), np.float32)
        label_mask = np.zeros((B, T, M), bool)
        for t in range(LABEL_EVERY - 1, T, LABEL_EVERY):
            ts = 1e6 + 5e4 * (i * T + t)
            labels[:, t, :3] = [(ts, 100.0, 80.0, 40.0, 30.0, 0.0, 1.0),
                                (ts, 30.0, 40.0, 25.0, 20.0, 1.0, 1.0),
                                (ts, 200.0, 120.0, 50.0, 35.0, 0.0, 1.0)]
            label_mask[:, t, :3] = True
        out.append(Batch(
            ev_repr=ev, labels=labels, label_mask=label_mask,
            frame_valid=label_mask.any(-1),
            is_first_sample=np.full((B,), i == 0),
            is_padded=np.zeros((B, T), bool),
            token_mask=(rng.rand(B, T, H // ps, W // ps) < 0.2
                        if masks else None)))
    return out


def same_trainer_state(a, b, what):
    """Parameters, buffers, moments, count and step, bit for bit."""
    import torch

    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad = [n for n in sa if not torch.equal(sa[n], sb[n])]
    bad += [f"moment {i}" for i, (x, y) in enumerate(zip(
        a.optimizer.mu + a.optimizer.nu, b.optimizer.mu + b.optimizer.nu))
        if not torch.equal(x, y)]
    if (bad or a.optimizer.count != b.optimizer.count
            or a._host_step != b._host_step):
        fail(f"{what}: state differs ({bad[:5]}, count "
             f"{b.optimizer.count} vs {a.optimizer.count}, step "
             f"{b._host_step} vs {a._host_step})")
    log(f"  {what}: {len(sa)} tensors of the model, "
        f"{2 * len(a.optimizer.mu)} moments, count and step bit for bit")


def run_trainer_path():
    """Phase 9: the Trainer at gen1 RVT-B (bf16, token masking, the train
    kernels) over 4 batches: logging every step, checkpoints at 2 and 4
    (published to an artifact registry), the gradflow and detection
    variants on their cadences. Then a fresh Trainer's ``restore()`` and
    another's ``restore_from_artifact("checkpoint@last")``, each held bit
    for bit and taking one more step. Returns (ms per step, frames/s,
    launch counts over the 4 + 1 + 1 steps)."""
    import json
    import tempfile
    from dataclasses import replace
    from pathlib import Path

    import torch

    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    from rvt_tpu_torch.ops.boxes import NMS_KEEP

    cfg = gen1_base_train_cfg(enable_masking=True)
    items = trainer_batches(cfg)
    # NMS: the detection variant's
    counters = stage_step_counters()[:-1] + (NMS_KEEP,)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        tcfg = TrainerConfig(
            max_steps=4, log_every_n_steps=1, ckpt_every_n_steps=2,
            gradflow_every_n_steps=4, detection_metrics_every_n_steps=4,
            detection_metrics_n_batches=2, prefetch_depth=2,
            ckpt_dir=f"{tmp}/run", artifact_dir=f"{tmp}/registry")
        trainer = Trainer(cfg, tcfg, model=gen1_base_model(cfg))
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = trainer.fit(iter(items))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / tcfg.max_steps
        lines = [json.loads(line) for line in
                 (Path(tcfg.ckpt_dir) / "metrics.jsonl").read_text()
                 .splitlines()]
        losses = [line["train/loss"] for line in lines
                  if "train/loss" in line]
        gf = [line["step"] for line in lines
              if any(k.startswith("train/gradflow/") for k in line)]
        ap = [line for line in lines if "train/AP" in line]
        log(f"trainer: 4 steps, losses {losses}, gradflow logged at {gf}, "
            f"train/AP {[(a['step'], a['train/AP']) for a in ap]}")
        if (trainer._host_step != 4 or len(losses) != 4 or gf != [4]
                or not all(math.isfinite(v) for v in losses)):
            fail("trainer: fit did not log 4 finite steps and the gradflow "
                 "step")
        # the step after restore() is a plain one (no checkpoint, variant
        # or publish on step 5): its profile is the masked train step's
        for what, kw, restore, profiled in (
                ("restore()", dict(artifact_dir=None), lambda t: t.restore(),
                 True),
                ("restore_from_artifact", dict(ckpt_dir=f"{tmp}/fresh"),
                 lambda t: t.restore_from_artifact("checkpoint@last"),
                 False)):
            fresh = Trainer(cfg, replace(tcfg, max_steps=5, **kw),
                            model=gen1_base_model(cfg, seed=1))
            if not restore(fresh):
                fail(f"trainer: {what} found no checkpoint")
            same_trainer_state(trainer, fresh, f"trainer {what}")
            if profiled:
                m = {}
                profile_window(lambda: m.update(fresh.fit(iter(items[:1]))),
                               "trainer step (masked, after restore)",
                               top=20)
            else:
                m = fresh.fit(iter(items[:1]))
            log(f"  one more step after {what}: loss {m['loss']:.6g}")
            if fresh._host_step != 5 or not math.isfinite(m["loss"]):
                fail(f"trainer: no finite step after {what}")
            del fresh
        counts = {c.name: c.launches for c in counters}
    log(f"trainer path: 4 + 1 + 1 steps, launches {counts}")
    for name, n in counts.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the trainer path")
    fps = BATCH * SEQ_LEN / dt
    log(f"trainer: {dt * 1e3:.2f} ms per step over fit's 4 steps "
        f"(checkpoints at 2 and 4, the detection variant on 3-4, gradflow "
        f"on 4 included), {fps:.1f} frames/s; the trainer's own count "
        f"{last['train/frames_per_s']:.1f} frames/s")
    return dt * 1e3, fps, counts


def shared_features(scan, kept):
    """A stand-in for the train step's backbone scan: the first call keeps
    its features in ``kept["first"]``; each later call keeps its own in
    ``kept["own"]`` and returns the first call's values, with its own
    gradient (straight through: f + (first - f), the difference detached,
    exact in f32 and rounded back to the first call's bf16 values)."""
    def run(model, ev_seq, init_states, *args, **kw):
        feats, states = scan(model, ev_seq, init_states, *args, **kw)
        if "first" not in kept:
            kept["first"] = tuple(f.detach() for f in feats)
            return feats, states
        kept["own"] = tuple(f.detach() for f in feats)
        return tuple((f.float() + (r.float() - f.float()).detach()
                      ).to(f.dtype) for f, r in zip(feats, kept["first"])
                     ), states

    return run


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
                      (7, f"per-step train window of {STEP_SEQ_LEN} calls"),
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
                nbytes += STEP_SEQ_LEN * (P * C * (2 * 2 + 8 * 4)
                                          + 2 * wbytes)
                ops += 3 * STEP_SEQ_LEN * (pair_ops + lstm_ops) // T
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


def all_counters():
    """Every kernel's launch counter."""
    from rvt_tpu_torch.ops import voxelization as vx

    return stage_step_counters() + (vx.STACKED_HISTOGRAM,)


def run_shipped_preset():
    """Phase 12: ``preset("gen1", "base")`` as it stands (fused_kernels
    off, f32: the module path at RVT-B's full widths, no kernel), random
    weights from seed 0 with gammas drawn at 0.1. The eval step at B = 8,
    T = 21 over 2 windows after a warm-up (frames/s, the idle share of a
    profiled window), a per-step forward over one window against the
    window scan bit for bit, two carried train steps (ms per step, peak
    memory), every kernel counter still 0; then the module path on the
    card against the same path on the CPU at gen1 tiny (64, 80), B = 2,
    T = 2: states and head outputs within 1e-4 of max|ref|. Returns
    frames/s, ms per step and peak GiB."""
    import copy

    import numpy as np
    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models import detector as det
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_eval_step, make_train_step

    cfg = preset("gen1", "base")
    if det.stage_routes(cfg.model, "train") != ["modules"] * 4:
        fail("the shipped preset does not route to the module path")
    model = gen1_base_model(cfg)
    for c in all_counters():
        c.reset()
    rng = np.random.RandomState(0)
    ev = torch.from_numpy(rng.randint(0, 8, size=(BATCH, SEQ_LEN, 240, 304,
                                                  20)).astype(np.uint8)).cuda()
    frame_valid = torch.from_numpy(
        (np.arange(SEQ_LEN) % LABEL_EVERY == LABEL_EVERY - 1)[None].repeat(
            BATCH, 0)).cuda()
    is_first = torch.zeros(BATCH, dtype=torch.bool, device="cuda")
    step = make_eval_step(model, cfg)
    out = step(zero_states(cfg.model.backbone, BATCH, device="cuda"), ev,
               frame_valid, is_first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        out = step(out.states, ev, frame_valid, is_first)
    dets_sum = float(out.dets.sum())
    torch.cuda.synchronize()
    fps = BATCH * SEQ_LEN * 2 / (time.perf_counter() - t0)
    if not np.isfinite(dets_sum) or not all(
            bool(torch.isfinite(h).all()) for h, _ in out.states):
        fail("shipped preset: non-finite eval outputs")
    log(f"shipped preset eval step (f32, modules): {fps:.1f} frames/s "
        f"over 2 windows of {BATCH} x {SEQ_LEN}; {CARD}")
    profile_window(lambda: step(out.states, ev, frame_valid, is_first),
                   "shipped-preset window")
    # a step at a time over one window vs the window scan
    from rvt_tpu_torch.training.step import pad_ev_repr

    with torch.inference_mode():
        seq = pad_ev_repr(ev, cfg.model.backbone.in_res_hw, None).transpose(
            0, 1)
        feats, states = det.scan_backbone(model, seq, out.states)
        st = out.states
        for t in range(SEQ_LEN):
            f, st = model.forward_backbone(seq[t], st)
            for i, s in enumerate(cfg.model.fpn.in_stages):
                if not torch.equal(f[s], feats[i][t]):
                    fail(f"per-step feature {s} at t={t} differs from the "
                         "window scan")
        if not all(torch.equal(a, b) for x, y in zip(st, states)
                   for a, b in zip(x, y)):
            fail("per-step states differ from the window scan")
    log("  per-step forward over one window equals the window scan bit for "
        "bit (features and states)")

    opt = make_optimizer(model.parameters(), cfg.training)
    train = make_train_step(model, cfg, opt)
    batch = train_batch(cfg, "cuda")
    states = zero_states(cfg.model.backbone, BATCH, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, metrics = train(states, *batch)
        loss = float(metrics["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss) or not np.isfinite(
                float(metrics["grad_norm"])):
            fail(f"shipped preset: non-finite train step ({metrics})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"shipped preset train step (f32, modules, checkpoint per step): "
        f"{times[0]:.2f}, {times[1]:.2f} ms, peak {peak:.2f} GiB, loss "
        f"{loss:.4f}; {CARD}")
    made = {c.name: c.launches for c in all_counters() if c.launches}
    if made:
        fail(f"the shipped preset's module path launched kernels: {made}")

    # the module path on the card vs on the CPU, gen1 tiny, f32
    tcfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=2,
                  max_labeled_frames=2)
    cpu_model = det.init_detector(tcfg.model, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    H, W = tcfg.model.backbone.in_res_hw
    evs = torch.from_numpy(rng.randint(0, 8, size=(2, 2, 64, 80, 20)
                                       ).astype(np.uint8))
    fv = torch.ones(2, 2, dtype=torch.bool)
    first = torch.ones(2, dtype=torch.bool)
    ref = make_eval_step(cpu_model, tcfg)(
        zero_states(tcfg.model.backbone, 2, device="cpu"), evs, fv, first)
    got = make_eval_step(gpu_model, tcfg)(
        zero_states(tcfg.model.backbone, 2, device="cuda"), evs.cuda(),
        fv.cuda(), first.cuda())
    pairs = [(f"stage {i + 1} {n}", g, r)
             for i, (gs, rs) in enumerate(zip(got.states, ref.states))
             for n, g, r in zip(("h", "c"), gs, rs)]
    pairs.append(("head outputs", got.preds, ref.preds))
    for name, g, r in pairs:
        err = float((g.cpu() - r).abs().max())
        scale = max(float(r.abs().max()), 1e-6)
        log(f"  card vs CPU, gen1 tiny f32, {name}: max|err| {err:.3e} "
            f"(tolerance 1e-4 * {scale:.3f})")
        if err > 1e-4 * scale:
            fail(f"shipped preset: the card's {name} disagrees with the CPU")
    return dict(fps=fps, ms=times[1], peak=peak)


VAL_LENGTHS = (100, 84, 80, 63, 60, 63, 42, 40, 42, 45)
# The random head scores every anchor within 1 % of its prior, 1e-4 (the
# obj and class biases' 0.01 each): at 2e-4 NMS would see no candidate.
# At 1e-4 about half of the anchors of a frame enter NMS.
VAL_CONF = 1e-4


# Phase 13's label boxes (x, y, w, h, class): 32x32 boxes on the stride-32
# cells where the random head's largest boxes lie (centred on the cells'
# corners), so that some detections match and the stats are not all zero
VAL_BOXES = ((16.0, 16.0, 32.0, 32.0, 0), (112.0, 80.0, 32.0, 32.0, 1),
             (208.0, 144.0, 32.0, 32.0, 0))
TINY_BOXES = ((16.0, 16.0, 32.0, 32.0, 0), (48.0, 16.0, 32.0, 32.0, 0),
              (24.0, 28.0, 32.0, 32.0, 1))


def memory_recordings(lengths, boxes, hw=(240, 304), seed=0,
                      max_labels=48):
    """Phase 13's recordings, one per length: a ``Recording`` whose uint8
    stacked histograms [n, 20, H, W] come from a numpy seed (values in
    [0, 8)) and whose labels are ``boxes`` on every 5th frame, stamped
    50 ms apart from 1 s. Nothing is read from disk: the card's machine
    has no h5py."""
    import numpy as np

    from rvt_tpu_torch.data.labels import LabelStore
    from rvt_tpu_torch.data.sequence import Recording

    H, W = hw

    class MemoryRecording(Recording):
        def __init__(self, rec_seed, n):
            rng = np.random.RandomState(rec_seed)
            self.path, self.max_labels = None, max_labels
            self.prefer_raw_chunks, self._h5, self._data = False, None, None
            self.ev = rng.randint(0, 8, size=(n, 20, H, W), dtype=np.uint8)
            self.num_ev_repr, self.ev_shape = n, (20, H, W)
            self.ev_dtype = self.ev.dtype
            labelled = np.arange(LABEL_EVERY - 1, n, LABEL_EVERY)
            self.objframe_idx_2_repr_idx = labelled
            self.repr_idx_2_objframe_idx = {int(r): i
                                            for i, r in enumerate(labelled)}
            rows = [(1e6 + 5e4 * r, *b, 1.0) for r in labelled for b in boxes]
            self.label_store = LabelStore(
                np.asarray(rows, np.float32),
                np.arange(0, len(rows), len(boxes)), input_size_hw=hw)

        def read_ev_repr(self, start, end):
            assert 0 <= start < end <= self.num_ev_repr
            return self.ev[start:end]

    return [MemoryRecording(seed + i, n) for i, n in enumerate(lengths)]


def with_conf(cfg, conf):
    from dataclasses import replace

    return replace(cfg, model=replace(cfg.model, postprocess=replace(
        cfg.model.postprocess, confidence_threshold=conf)))


class first_window_timer:
    """Wraps a batch iterable; ``start`` is the host time (after a
    synchronize) at which the loop asks for its second window, i.e.
    after the first window's step: the loop's time from there on is the
    timed part, the first window its warm-up."""

    def __init__(self, batches):
        self.batches, self.start = batches, None

    def __iter__(self):
        import torch

        for i, b in enumerate(self.batches):
            if i == 1:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.start = time.perf_counter()
            yield b


class recorded_evaluator:
    """Within the block, keep the PropheseeEvaluator each
    ``run_streaming_eval`` makes (its per-frame buffers)."""

    def __enter__(self):
        from rvt_tpu_torch.training import evaluator_loop as el

        self.el, self.real, made = el, el.PropheseeEvaluator, []
        self.made = made

        class Recorded(self.real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        el.PropheseeEvaluator = Recorded
        return made

    def __exit__(self, *exc):
        self.el.PropheseeEvaluator = self.real


def canonical_rows(p):
    """Detection rows by box corner and size rounded to the pixel: the
    order of rows whose scores tie within rounding is not the protocol's."""
    import numpy as np

    key = np.round(np.stack([p["x"], p["y"], p["w"], p["h"]])).astype(int)
    return p[np.lexsort(key[::-1])]


def same_buffers(a, b) -> bool:
    """Two evaluators hold the same frames bit for bit."""
    import numpy as np

    return (len(a._labels) == len(b._labels)
            and len(a._predictions) == len(b._predictions)
            and all(np.array_equal(x, y) for x, y in zip(
                a._labels + a._predictions, b._labels + b._predictions)))


def same_detections(got, ref, what):
    """Per-frame detections of two evaluators: counts equal, boxes and
    scores within 1e-4 of max|ref| (after ``canonical_rows``). Returns
    (frames, detections, max relative error)."""
    import numpy as np

    if len(got._predictions) != len(ref._predictions):
        fail(f"{what}: {len(got._predictions)} frames vs "
             f"{len(ref._predictions)}")
    worst, n = 0.0, 0
    for i, (a, b) in enumerate(zip(got._predictions, ref._predictions)):
        if len(a) != len(b):
            fail(f"{what}: frame {i} has {len(a)} detections vs {len(b)}")
        a, b = canonical_rows(a), canonical_rows(b)
        if not (np.array_equal(a["class_id"], b["class_id"])
                and np.array_equal(a["t"], b["t"])):
            fail(f"{what}: frame {i}: classes or times differ")
        for f in ("x", "y", "w", "h", "class_confidence"):
            ref_f = b[f].astype(np.float64)
            scale = max(np.abs(ref_f).max(initial=0.0), 1e-6)
            err = np.abs(a[f] - ref_f).max(initial=0.0) / scale
            worst = max(worst, err)
            if err > 1e-4:
                fail(f"{what}: frame {i}: {f} differs by {err:.3e} of "
                     "max|ref|")
        n += len(a)
    return len(got._predictions), n, worst


def eval_window_parts(step, cfg, batch, states, evaluator, parts, feed):
    """One window fed by hand as ``run_streaming_eval`` feeds it, each part
    timed on the host clock into ``parts`` (ms): the stored layout's copy
    into a pinned slot of ``feed`` with its H2D issued ("pinned copy"),
    the feed's channel-last view ("card layout"; the s2d step blocks it
    itself, ``ops/s2d.py:window_s2d``), the eval step until it returns (a
    replay: the host only issues), the wait for its outputs' host copy
    (which takes the card's whole window: H2D, layout, step) and the
    conversion to protocol arrays. Returns the step's output."""
    import torch

    from rvt_tpu_torch.training.evaluator_loop import (fetch_outputs,
                                                       iter_batch_detections)
    from rvt_tpu_torch.training.feed import stored_layout, window_input

    bb = cfg.model.backbone
    t0 = time.perf_counter()
    ev, stored = stored_layout(batch.ev_repr)
    ev, fv, first = feed([ev, batch.frame_valid, batch.is_first_sample])
    t1 = time.perf_counter()
    x = window_input(ev, stored, bb.in_res_hw, bb.stem_s2d)
    t2 = time.perf_counter()
    out = step(states, x, fv, first)
    t3 = time.perf_counter()
    arrays = fetch_outputs((out.dets, out.det_valid, out.frame_idx,
                            out.gval), torch.device("cuda"))()
    t4 = time.perf_counter()
    frames = list(iter_batch_detections(batch, *arrays))
    if frames:
        evaluator.add_labels([f[2] for f in frames])
        evaluator.add_predictions([f[3] for f in frames])
    t5 = time.perf_counter()
    for k, a, b in (("pinned copy", t0, t1), ("card layout", t1, t2),
                    ("eval step", t2, t3), ("output wait", t3, t4),
                    ("conversion", t4, t5)):
        parts.setdefault(k, []).append((b - a) * 1e3)
    return out


def run_validation_path(eval_counts):
    """Phase 13: the validation path (``run_streaming_eval`` over
    ``EvalStreamScheduler`` windows of in-memory recordings), with
    ``eval_counts`` the eval step's launches over phase 4's windows.
    Returns (numbers for the summary line, the loop's launches by
    kernel)."""
    import copy
    import tempfile
    from dataclasses import replace
    from pathlib import Path

    import torch

    from rvt_tpu_torch.cli.validate import load_model, serve_fused_config
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.data.sequence import StreamView
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.evaluation.prophesee import PropheseeEvaluator
    from rvt_tpu_torch.models import detector as det
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.ops import boxes
    from rvt_tpu_torch.ops.fused_attention import (GEMM_BF16, LN_ROWS,
                                                   PARTITION_ATTENTION)
    from rvt_tpu_torch.ops.fused_scan import LSTM_SCAN
    from rvt_tpu_torch.ops.s2d import WINDOW_S2D
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval
    from rvt_tpu_torch.training.feed import PinnedFeed
    from rvt_tpu_torch.training.step import _postprocess_window, make_eval_step
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    keys = {"AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L"}
    res = {}
    # 1. the loop on the kernels at full width, timed after its first window
    cfg = with_conf(serve_fused_config(preset("gen1", "base")), VAL_CONF)
    model = gen1_base_model(cfg)
    t0 = time.perf_counter()
    views = [StreamView(r, SEQ_LEN)
             for r in memory_recordings(VAL_LENGTHS, VAL_BOXES)]
    log(f"validation data: {len(views)} in-memory recordings of "
        f"{VAL_LENGTHS} frames made in {time.perf_counter() - t0:.1f} s")
    sched = EvalStreamScheduler(views, BATCH)
    n_win = len(sched)
    plans = list(sched.plan_batches())
    fills = sum(p.window_idx < 0 for b in plans for p in b)
    restarts = sum(p.window_idx == 0 for b in plans[1:] for p in b)
    if n_win < 5 or not fills or not restarts:
        fail(f"validation: {n_win} windows, {fills} fill windows, "
             f"{restarts} mid-run restarts")
    counters = (LN_ROWS, GEMM_BF16, PARTITION_ATTENTION, LSTM_SCAN,
                boxes.NMS_KEEP, WINDOW_S2D)
    for c in counters:
        c.reset()
    timer = first_window_timer(sched)
    metrics = run_streaming_eval(model, cfg, timer, BATCH)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - timer.start
    counts = {c.name: c.launches for c in counters}
    want = {k: v // WINDOWS * n_win for k, v in eval_counts.items()
            if k in counts}
    log(f"validation loop: {n_win} windows of {BATCH} x {SEQ_LEN} "
        f"({fills} padded fill windows, {restarts} lanes restarting "
        f"mid-run), launches {counts} (the eval step's per window x "
        f"windows: {want}); metrics {metrics}")
    if counts != want:
        fail("validation: the loop's kernel launches are not the eval "
             "step's per window x windows")
    if metrics is None or set(metrics) != keys or not all(
            math.isfinite(v) for v in metrics.values()):
        fail(f"validation: bad metrics {metrics}")
    res["loop_fps"] = BATCH * SEQ_LEN * (n_win - 1) / loop_s

    # the same windows fed by hand, each part timed
    items, read_ms = [], []
    it = iter(EvalStreamScheduler(views, BATCH))
    while True:
        t0 = time.perf_counter()
        b = next(it, None)
        if b is None:
            break
        read_ms.append((time.perf_counter() - t0) * 1e3)
        items.append(b)
    step = make_eval_step(model, cfg)
    evaluator = PropheseeEvaluator("gen1", False)
    states = zero_states(cfg.model.backbone, BATCH, device="cuda")
    parts, cand, kept, rounds, calls, pp_ms = {}, [], [], 0, 0, []
    scores, pp_plain_ms, feed = [], [], PinnedFeed("cuda")
    for b in items:
        out = eval_window_parts(step, cfg, b, states, evaluator, parts, feed)
        states = out.states
        # the window's NMS alone: nms_keep, then the plain route (Jacobi,
        # a host read a round), identical detections
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk = _postprocess_window(out.preds, out.frame_idx, out.gval, cfg)
        torch.cuda.synchronize()
        pp_ms.append((time.perf_counter() - t0) * 1e3)
        boxes.NMS_STATS.update(calls=0, rounds=0)
        t0 = time.perf_counter()
        dp = _postprocess_window(out.preds, out.frame_idx, out.gval, cfg,
                                 plain=True)
        torch.cuda.synchronize()
        pp_plain_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.equal(x, y) for x, y in zip(dk, dp)):
            fail("validation: nms_keep's detections on the random head's "
                 "frames differ from the plain route's")
        rounds += boxes.NMS_STATS["rounds"]
        calls += boxes.NMS_STATS["calls"]
        p = out.preds.float()
        score = torch.sigmoid(p[..., 4]) * torch.sigmoid(p[..., 5:]).amax(-1)
        n = (score >= VAL_CONF).sum(-1)[out.gval.reshape(-1)]
        cand += n.tolist()
        scores.append(score[out.gval.reshape(-1)].flatten())
        kept += out.det_valid.sum(-1)[out.gval].tolist()
    t0 = time.perf_counter()
    twin = evaluator.evaluate_buffer(img_height=240, img_width=304)
    proto_s = time.perf_counter() - t0
    if twin != metrics:
        fail(f"validation: the loop's metrics {metrics} differ from the "
             f"same windows fed by hand {twin}")
    log(f"  the same {n_win} windows fed by hand (make_eval_step, "
        "iter_batch_detections, PropheseeEvaluator): the metrics bit for "
        "bit")
    # the loop eagerly and captured over the windows read beforehand,
    # each timed after its first window (the captured loop's warm-up and
    # capture): the same metrics
    from rvt_tpu_torch.training import graphs

    res["loop_fps_read"], peaks = {}, {}
    for mode in ("eager", "captured"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer = first_window_timer(items)
        with (graphs.eager() if mode == "eager"
              else contextlib.nullcontext()):
            again = run_streaming_eval(model, cfg, timer, BATCH)
        torch.cuda.synchronize()
        res["loop_fps_read"][mode] = (BATCH * SEQ_LEN * (n_win - 1)
                                      / (time.perf_counter() - timer.start))
        peaks[mode] = peak_memory()
        if again != metrics:
            fail(f"validation: the loop {mode} gives {again}")
    log("  the loop over the windows read beforehand (feed, step, NMS, "
        "conversion, the protocol): captured "
        f"{res['loop_fps_read']['captured']:.1f} frames/s, eager "
        f"{res['loop_fps_read']['eager']:.1f}, the same metrics; peak "
        "allocated / reserved GiB: captured "
        f"{peaks['captured']['peak_gib']:.2f} / "
        f"{peaks['captured']['reserved_gib']:.2f}, eager "
        f"{peaks['eager']['peak_gib']:.2f} / "
        f"{peaks['eager']['reserved_gib']:.2f}; {CARD}")
    parts["read+stack"] = read_ms
    parts["postprocess (rerun alone)"] = pp_ms
    parts["postprocess, plain route"] = pp_plain_ms
    per = {k: sum(v[1:]) / len(v[1:]) for k, v in parts.items()}
    res["parts"] = per
    res["protocol_s"] = proto_s
    res["candidates"] = (min(cand), sum(cand) / len(cand), max(cand),
                         int(out.preds.shape[1]))
    res["rounds"] = rounds / max(calls, 1)
    log("  ms per window (after the first): "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; evaluate_buffer at the end {proto_s * 1e3:.1f} ms over "
        f"{len(evaluator._labels)} labelled frames; {CARD}")
    scores = torch.cat(scores)
    q = torch.quantile(scores, torch.tensor([0.0, 0.01, 0.5, 0.99, 1.0],
                                            device=scores.device))
    log("  scores (obj x class) of the labelled frames' anchors: min, 1 %, "
        "50 %, 99 %, max " + ", ".join(f"{v:.4e}" for v in q.tolist())
        + f"; {int((scores >= 2e-4).sum())} of {scores.numel()} at >= 2e-4")
    log(f"  NMS: {min(cand)}-{max(cand)} candidates per labelled frame "
        f"(mean {res['candidates'][1]:.1f} of {res['candidates'][3]} "
        f"anchors, threshold {VAL_CONF:g}); nms_keep's detections equal "
        f"the plain route's bit for bit in every window (the plain route: "
        f"{res['rounds']:.1f} Jacobi rounds a call, each read on the "
        f"host); {min(kept)}-{max(kept)} detections kept a frame "
        f"(max_detections {cfg.model.postprocess.max_detections})")
    for mode in ("captured", "eager"):
        with (graphs.eager() if mode == "eager"
              else contextlib.nullcontext()):
            profile_window(lambda: eval_window_parts(
                step, cfg, items[1], states, PropheseeEvaluator("gen1"), {},
                feed), f"validation window, {mode} (pinned copy, H2D, "
                "step with the window's layout, conversion)")
    log(f"validation loop: {res['loop_fps']:.1f} frames/s over {n_win - 1} "
        f"windows after the first (read, stack, H2D, s2d, step, NMS, "
        f"conversion and the protocol included); {CARD}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_val_") as tmp:
        # 2. an upstream-layout Lightning checkpoint, loaded by the CLI's
        # loader into a fresh model
        ckpt = Path(tmp) / "rvt-b.ckpt"
        torch.save({"state_dict": {"mdl." + k: v for k, v in
                                   model.state_dict().items()}}, ckpt)
        got = run_streaming_eval(load_model(ckpt, cfg, "cuda"), cfg,
                                 iter(items), BATCH)
        if got != metrics:
            fail(f"validation: the .ckpt round trip gives {got}")
        log("  .ckpt round trip (load_torch_checkpoint into a fresh model):"
            " the metrics bit for bit")
        del model, step

        # 3. the Trainer validating every step, its evaluators' buffers
        # kept: each validation's detections equal a fresh loop's on that
        # step's weights, and the two steps' differ
        tcfg = with_conf(gen1_base_train_cfg(), VAL_CONF)
        train_items = [replace(b, token_mask=None)
                       for b in trainer_batches(tcfg, 2)]
        snaps, seen = [], []

        def eval_fn(m):
            snaps.append({k: v.detach().clone()
                          for k, v in m.state_dict().items()})
            seen.append(run_streaming_eval(m, tcfg, iter(items), BATCH))
            return seen[-1]

        trainer = Trainer(tcfg, TrainerConfig(
            max_steps=2, log_every_n_steps=1, ckpt_every_n_steps=100,
            val_every_n_steps=1, gradflow_every_n_steps=0,
            detection_metrics_every_n_steps=2, detection_metrics_n_batches=1,
            prefetch_depth=2, ckpt_dir=f"{tmp}/run",
            train_viz_dir=f"{tmp}/viz"), model=gen1_base_model(tcfg))
        with recorded_evaluator() as made:
            trainer.fit(iter(train_items), eval_fn=eval_fn)
            for i, snap in enumerate(snaps):
                fresh = det.RVTDetector(tcfg.model)
                fresh.load_state_dict(snap, strict=True)
                got = run_streaming_eval(fresh.cuda().eval(), tcfg,
                                         iter(items), BATCH)
                if got != seen[i] or not same_buffers(made[i],
                                                      made[2 + i]):
                    fail(f"trainer validation {i + 1}: {seen[i]}, a fresh "
                         f"loop on that step's weights {got}")
        if len(seen) != 2 or same_buffers(made[0], made[1]):
            fail("trainer validation: the two steps' detections are the "
                 "same")
        best = trainer.ckpt.best_step()
        got = run_streaming_eval(load_model(f"{tmp}/run", tcfg, "cuda"),
                                 tcfg, iter(items), BATCH)
        panels = sorted(Path(f"{tmp}/viz").glob("step_*.png"))
        log(f"  trainer: validations at steps 1 and 2 {seen}; best slot "
            f"{best}; {len(panels)} train panels")
        if best not in (1, 2) or got != seen[best - 1] or not panels:
            fail(f"trainer validation: best slot {best} gives {got}, "
                 f"{len(panels)} panels")
        log("  each validation's detections and metrics equal a fresh "
            "loop's on its step's weights, the two steps' detections "
            "differ; cli.validate's loader restores the best slot to its "
            "metrics bit for bit")
        del trainer, fresh

    # 4. the shipped preset (f32, modules) over one timed window
    shipped = preset("gen1", "base")
    timer = first_window_timer(items[:2])
    m = run_streaming_eval(gen1_base_model(shipped), shipped, timer, BATCH)
    torch.cuda.synchronize()
    res["shipped_fps"] = BATCH * SEQ_LEN / (time.perf_counter() - timer.start)
    if m is None or set(m) != keys or not all(math.isfinite(v)
                                              for v in m.values()):
        fail(f"shipped preset validation: bad metrics {m}")
    log(f"shipped preset validation loop (f32, modules): "
        f"{res['shipped_fps']:.1f} frames/s over 1 window after 1; {CARD}")
    torch.cuda.empty_cache()

    # the loop on the card against the CPU at gen1 tiny, f32; every anchor
    # enters NMS (threshold 1e-6) and class 1's biases sit 1 below class
    # 0's, so that no class decision is a near-tie of two 0.01 priors
    tiny = with_conf(preset("gen1", "tiny", resolution_hw=(64, 80),
                            sequence_length=5), 1e-6)
    cpu_model = det.init_detector(tiny.model, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=gen)
            elif name.startswith("yolox_head.cls_preds") and name.endswith(
                    "bias"):
                p[1:] -= 1.0
    gpu_model = copy.deepcopy(cpu_model).cuda()
    tviews = [StreamView(r, 5) for r in memory_recordings(
        (23, 17, 12, 30), TINY_BOXES, hw=(64, 80), seed=100)]
    with recorded_evaluator() as made:
        ref = run_streaming_eval(cpu_model, tiny,
                                 iter(EvalStreamScheduler(tviews, 2)), 2,
                                 device="cpu")
        got = run_streaming_eval(gpu_model, tiny,
                                 iter(EvalStreamScheduler(tviews, 2)), 2)
    frames, dets, err = same_detections(made[1], made[0], "card vs CPU")
    worst = max(abs(got[k] - ref[k]) for k in keys)
    log(f"  card vs CPU, gen1 tiny f32 loop: {frames} labelled frames, "
        f"{dets} detections, boxes and scores within {err:.2e} of "
        f"max|ref| (tolerance 1e-4); stats {got}, max |diff| {worst:.2e} "
        "(tolerance 1e-4)")
    if worst > 1e-4:
        fail("card vs CPU: the loop's stats differ")
    return res, counts


CLI_SPLIT = 7  # phase 14: the first 7 recordings train, the last 3 validate


def timed_steps(trainer):
    """Wrap ``trainer._fit_one`` to note the host clock after each step
    (synchronised) and the seconds its validation took; returns (marks,
    validation seconds by step)."""
    import torch

    marks, val_s = [time.perf_counter()], {}
    fit_one = trainer._fit_one

    def one(batch, eval_fn):
        def timed_eval(model):
            t0 = time.perf_counter()
            out = eval_fn(model)
            torch.cuda.synchronize()
            val_s[len(marks)] = time.perf_counter() - t0
            return out

        out = fit_one(batch, None if eval_fn is None else timed_eval)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    trainer._fit_one = one
    return marks, val_s


def step_ms(marks, val_s):
    """ms per step after the first, each step's validation taken out."""
    steps = [(marks[i + 1] - marks[i] - val_s.get(i + 1, 0.0)) * 1e3
             for i in range(1, len(marks) - 1)]
    return sum(steps) / len(steps)


def native_matcher_check():
    """Whether ``rvt_tpu_torch.native_lib`` loads the in-repo library on
    this machine; when it does, its COCO matcher against the numpy one
    on random scenes (the same metrics)."""
    import numpy as np

    from rvt_tpu_torch import native_lib
    from rvt_tpu_torch.evaluation import coco

    loaded = native_lib.get_lib() is not None
    log(f"native_lib: {'loaded' if loaded else 'not loaded'} "
        f"({native_lib._LIB_PATH.name}); the COCO matcher runs "
        f"{'natively' if loaded else 'in numpy'}")
    if not loaded:
        return False
    rng = np.random.RandomState(0)
    gts, dts = [], []
    for _ in range(40):
        n, m = rng.randint(1, 6), rng.randint(0, 12)
        g = np.concatenate([rng.uniform(0, 200, (n, 2)),
                            rng.uniform(8, 90, (n, 2)),
                            rng.randint(0, 2, (n, 1))], 1)
        d = np.concatenate([rng.uniform(0, 200, (m, 2)),
                            rng.uniform(8, 90, (m, 2)),
                            rng.randint(0, 2, (m, 1)),
                            rng.uniform(0.1, 1, (m, 1))], 1)
        k = min(n, m)
        d[:k, :4] = g[:k, :4] + rng.normal(0, 2, (k, 4))
        d[:k, 4] = g[:k, 4]
        gts.append(g)
        dts.append(d)
    native = coco.evaluate_coco_map(gts, dts, num_classes=2)
    real = native_lib.coco_match_image
    native_lib.coco_match_image = lambda *a, **k: None
    try:
        numpy_ = coco.evaluate_coco_map(gts, dts, num_classes=2)
    finally:
        native_lib.coco_match_image = real
    if native != numpy_:
        fail(f"native_lib: the native COCO matcher gives {native}, the "
             f"numpy one {numpy_}")
    log(f"  native and numpy matchers: the same metrics (AP "
        f"{native['AP']:.4f}) over 40 random images")
    return True


def run_train_cli_path(dev="cuda", hw=(240, 304), size="base"):
    """Phase 14: training from recordings through the training CLI's own
    functions (``cli/train.py``: ``build_train_scheduler``,
    ``make_eval_fn``, ``--init_ckpt``'s loader) over phase 13's in-memory
    recordings (10 at ``hw``: 7 train, 3 val). The mixed sampler at B =
    8, T = 21 (4 stream lanes, 4 random lanes, augmentation on): 6
    batches equal serially and through 2 thread workers, random lanes
    reset every batch, a window flipped and one zoomed, the loader's
    frames/s. Then ``preset("gen1", size)`` as the CLI trains it, 3 steps
    with validation at step 2 and checkpoints, after an upstream .ckpt
    loaded bit for bit; the train kernels config for 2 steps (K1-K8 and
    train_reduce launched); each fed by the scheduler (prefetch on) and
    by the same batches stacked beforehand. Last, the CLI's first step
    on the card against the CPU at gen1 tiny, f32. Returns (numbers for
    the summary line, the kernels run's launches)."""
    import copy
    import tempfile
    from dataclasses import replace
    from pathlib import Path

    import numpy as np
    import torch

    from rvt_tpu_torch.cli.train import build_train_scheduler, make_eval_fn
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.convert.torch_ckpt import load_torch_checkpoint
    from rvt_tpu_torch.data.random_access import split_batch_size
    from rvt_tpu_torch.data.sequence import StreamView
    from rvt_tpu_torch.data.streaming import _stack
    from rvt_tpu_torch.models.detector import init_detector, stage_routes
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    res = {"native": native_matcher_check()}
    frames = BATCH * SEQ_LEN

    def batch_size(cfg, b=BATCH):  # what --batch_size sets
        return replace(cfg, batch_size=replace(cfg.batch_size, train=b,
                                               eval=b))

    t0 = time.perf_counter()
    recs = memory_recordings(VAL_LENGTHS, VAL_BOXES, hw=hw, seed=200)
    train_recs, val_recs = recs[:CLI_SPLIT], recs[CLI_SPLIT:]
    shipped = batch_size(preset("gen1", size))
    n_stream, n_random = split_batch_size(BATCH)
    if shipped.dataset.train_sampling != "mixed":
        fail(f"train cli: gen1 samples {shipped.dataset.train_sampling!r}")

    def scheduler(workers=0):
        return build_train_scheduler(shipped, train_recs, seed=0,
                                     num_workers=workers)

    # 1. the batches: serial against 2 thread workers, timed
    n = 6
    got = {}
    for workers in (0, 2):
        it = iter(scheduler(workers))
        t1 = time.perf_counter()
        got[workers] = [next(it) for _ in range(n)]
        got[f"{workers}_s"] = time.perf_counter() - t1
        if hasattr(it, "close"):
            it.close()
    for i, (a, b) in enumerate(zip(got[0], got[2])):
        for f in ("ev_repr", "labels", "label_mask", "frame_valid",
                  "is_first_sample", "is_padded"):
            if not (getattr(a, f) == getattr(b, f)).all():
                fail(f"train cli: batch {i}'s {f} differs serially and "
                     "through 2 thread workers")
    plans = [p for ps in itertools.islice(scheduler().plan_batches(), n)
             for p in ps]
    flips = sum(bool(p.aug_state and p.aug_state.h_flip) for p in plans)
    zooms = sum(bool(p.aug_state and (p.aug_state.zoom_in_factor
                                      or p.aug_state.zoom_out))
                for p in plans)
    resets = [int(b.is_first_sample.sum()) for b in got[0]]
    log(f"train cli data: {len(train_recs)} train + {len(val_recs)} val "
        f"in-memory recordings of {VAL_LENGTHS} frames at {hw}; mixed "
        f"sampler {n_stream} stream + {n_random} random lanes, B = {BATCH}, "
        f"T = {SEQ_LEN}; {n} batches equal bit for bit serially and through "
        f"2 thread workers; {flips} of {len(plans)} windows flipped, {zooms} "
        f"zoomed; lanes starting a sample per batch {resets}")
    if not all(b.is_first_sample[n_stream:].all() for b in got[0]):
        fail("train cli: a random lane carried its state")
    if not flips or not zooms:
        fail(f"train cli: {flips} windows flipped, {zooms} zoomed")
    res["loader_fps"] = (n * frames / got["0_s"], n * frames / got["2_s"])
    log(f"train loader: {res['loader_fps'][0]:.1f} frames/s serially, "
        f"{res['loader_fps'][1]:.1f} with 2 thread workers ({n} batches of "
        f"{frames} frames: sample, read, augment, stack); {CARD}")
    items = got[0]
    del got
    # the serial loader's batch by part: the windows' reads alone, then
    # read + augment (fetch), the stack, and the Trainer's feed of the
    # window (its stored layout into a pinned slot, the H2D; synchronised)
    from rvt_tpu_torch.training.feed import PinnedFeed, stored_layout

    sched, parts, feed = scheduler(), {}, PinnedFeed("cuda")
    for plans in itertools.islice(sched.plan_batches(), n):
        t1 = time.perf_counter()
        for p in plans:
            view = (sched.random.views[p.stream_idx] if p.source
                    else sched.stream.streams[p.stream_idx])
            view[p.window_idx]
        t2 = time.perf_counter()
        samples = [sched.fetch(p) for p in plans]
        t3 = time.perf_counter()
        batch = _stack(samples)
        t4 = time.perf_counter()
        feed([stored_layout(batch.ev_repr)[0]])
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        for k, v in (("read", t2 - t1), ("read+augment", t3 - t2),
                     ("stack", t4 - t3),
                     ("pinned copy + H2D (the Trainer's feed)", t5 - t4)):
            parts.setdefault(k, []).append(v * 1e3)
    res["loader_parts"] = {k: sum(v) / len(v) for k, v in parts.items()}
    log("  ms a batch, serially: " + ", ".join(
        f"{k} {v:.1f}" for k, v in res["loader_parts"].items())
        + f"; {CARD}")

    def trainer_cfg(tmp, name, steps, **kw):
        return TrainerConfig(**dict(dict(
            max_steps=steps, log_every_n_steps=1, ckpt_every_n_steps=100,
            gradflow_every_n_steps=0, detection_metrics_every_n_steps=0,
            ckpt_dir=f"{tmp}/{name}"), **kw))

    def fit_timed(trainer, batches, eval_fn=None):
        marks, val_s = timed_steps(trainer)
        last = trainer.fit(batches, eval_fn=eval_fn)
        if not all(math.isfinite(v) for v in last.values()):
            fail(f"train cli: non-finite metrics {last}")
        return step_ms(marks, val_s), last, val_s

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        # 2. the shipped preset as the CLI trains it: its Trainer takes
        # the compute dtype from training.precision, as JAX's does
        compute = ("bfloat16" if shipped.training.precision
                   in ("bf16", "bfloat16") else "float32")
        ckpt = Path(tmp) / "rvt-b.ckpt"
        src = gen1_base_model(replace(shipped, model=replace(
            shipped.model, compute_dtype=compute)))
        torch.save({"state_dict": {"mdl." + k: v for k, v in
                                   src.state_dict().items()}}, ckpt)
        val_streams = [StreamView(r, SEQ_LEN) for r in val_recs]
        eval_fn = make_eval_fn(shipped, val_streams, device=dev)
        ms = {}
        for feed in ("scheduler", "stacked"):
            trainer = Trainer(shipped, trainer_cfg(
                tmp, f"shipped_{feed}", 3, ckpt_every_n_steps=3,
                val_every_n_steps=2 if feed == "scheduler" else None),
                seed=0, device=dev)
            load_torch_checkpoint(ckpt, trainer.model)  # --init_ckpt
            sd, ref = trainer.model.state_dict(), src.state_dict()
            bad = [k for k in ref if not torch.equal(sd[k], ref[k])]
            if bad or sd.keys() != ref.keys():
                fail(f"train cli: --init_ckpt loaded {bad[:5]} otherwise")
            routes = stage_routes(trainer.model.cfg, "train")
            ms[feed], last, val_s = fit_timed(
                trainer, iter(scheduler()) if feed == "scheduler"
                else iter(items), eval_fn if feed == "scheduler" else None)
            if feed == "scheduler":
                mgr = trainer.ckpt
                if (mgr.latest_step() != 3 or mgr.best_step() != 2
                        or len(val_s) != 1):
                    fail(f"train cli: checkpoints at {mgr.latest_step()}, "
                         f"best {mgr.best_step()}, validations {val_s}")
                log(f"train cli, shipped gen1 RVT-{size[0].upper()} "
                    f"({compute} compute as training.precision "
                    f"{shipped.training.precision!r} sets it, routes "
                    f"{routes}): --init_ckpt bit for bit ({len(ref)} "
                    f"tensors), 3 steps, validation at step 2 in "
                    f"{val_s[2]:.2f} s, checkpoints at 2 (best) and 3; "
                    f"last metrics {last}")
            del trainer
            torch.cuda.empty_cache()
        del src
        res["shipped_ms"] = (ms["scheduler"], ms["stacked"])
        log(f"train cli, shipped preset: {ms['scheduler']:.2f} ms a step fed "
            f"by the scheduler (prefetch 4), {ms['stacked']:.2f} fed by the "
            f"same batches stacked beforehand (steps 2-3, validation "
            f"excluded); {CARD}")

        # 3. the train kernels config on the same scheduler, 2 steps; fed
        # also by 2 thread workers (--num_workers 2)
        kcfg = batch_size(gen1_base_train_cfg())
        counters = stage_step_counters()[:-1]
        feeds = {"scheduler": lambda: iter(scheduler()),
                 "2 workers": lambda: iter(scheduler(2)),
                 "stacked": lambda: iter(items),
                 "scheduler, eager": lambda: iter(scheduler()),
                 "stacked, eager": lambda: iter(items)}
        from rvt_tpu_torch.training import graphs

        peaks = {}
        for feed, batches in feeds.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(kcfg, trainer_cfg(tmp, f"kernels_{len(ms)}",
                                                2),
                              model=gen1_base_model(kcfg))
            if feed == "scheduler":
                for c in counters:
                    c.reset()
            with (graphs.eager() if feed.endswith("eager")
                  else contextlib.nullcontext()):
                ms[feed], last, _ = fit_timed(trainer, batches())
            peaks[feed] = peak_memory()
            if feed == "scheduler":
                counts = {c.name: c.launches for c in counters}
            del trainer
            torch.cuda.empty_cache()
        log(f"train cli path (kernels config, 2 steps): launches {counts}")
        for name, k in counts.items():
            if k == 0:
                fail(f"kernel {name} was not launched on the train cli path")
        res["kernels_ms"] = tuple(ms[f] for f in feeds)
        log(f"train cli, kernels config: {ms['scheduler']:.2f} ms a step fed "
            f"by the scheduler (prefetch 4), {ms['2 workers']:.2f} by the "
            f"scheduler through 2 thread workers, {ms['stacked']:.2f} by the "
            f"same batches stacked beforehand (step 2, captured); eager "
            f"steps: {ms['scheduler, eager']:.2f} fed by the scheduler, "
            f"{ms['stacked, eager']:.2f} pre-stacked; peak allocated / "
            "reserved GiB fed by the scheduler: captured "
            f"{peaks['scheduler']['peak_gib']:.2f} / "
            f"{peaks['scheduler']['reserved_gib']:.2f}, eager "
            f"{peaks['scheduler, eager']['peak_gib']:.2f} / "
            f"{peaks['scheduler, eager']['reserved_gib']:.2f}; {CARD}")

        # 4. the CLI's first step on the card against the CPU: gen1 tiny,
        # f32, B = 2, T = 5, the same augmented batch and initial weights
        tiny = batch_size(preset("gen1", "tiny", resolution_hw=(64, 80),
                                 sequence_length=5), 2)
        tiny = replace(tiny, training=replace(tiny.training,
                                              precision="32"))
        trecs = memory_recordings((23, 17, 12, 30), TINY_BOXES,
                                  hw=(64, 80), seed=300)
        batch = next(iter(build_train_scheduler(tiny, trecs, seed=0)))
        cpu_model = init_detector(tiny.model, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, p in cpu_model.named_parameters():
                if name.endswith(".gamma"):
                    p.normal_(0.0, 0.1, generator=gen)
        metrics = {}
        for where, model in (("cpu", copy.deepcopy(cpu_model)),
                             (dev, copy.deepcopy(cpu_model).to(dev))):
            trainer = Trainer(tiny, trainer_cfg(tmp, f"tiny_{where}", 1,
                                                prefetch_depth=0),
                              model=model)
            metrics[where] = trainer.fit(iter([batch]))
        ref, got = metrics["cpu"], metrics[dev]
        keys = sorted(k for k in ref if k != "train/frames_per_s")
        errs = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)
                for k in keys}
        log(f"  card vs CPU, the CLI's first step at gen1 tiny f32 (B = 2, "
            f"T = 5, mixed batch, {int(batch.is_first_sample.sum())} lanes "
            f"starting): " + ", ".join(f"{k} {ref[k]:.6g} ({errs[k]:.1e})"
                                       for k in keys)
            + " (relative difference, tolerance 1e-4)")
        if not keys or any(not e <= 1e-4 for e in errs.values()):
            fail("train cli: the card's first step disagrees with the CPU")
    return res, counts


def same_leaves(a, b, what):
    """Every tensor leaf of two output trees equal bit for bit; returns
    how many there are."""
    import torch
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if isinstance(x, torch.Tensor) and not torch.equal(x, y)]
    if len(la) != len(lb) or bad:
        fail(f"{what}: captured differs from eager ({len(bad)} of "
             f"{len(la)} tensors, the first at leaf {bad[:1]})")
    return sum(isinstance(x, torch.Tensor) for x in la)


def same_training_state(ma, oa, mb, ob, what):
    """Parameters, BatchNorm buffers, gradients and moments of two models
    and optimizers, bit for bit; returns how many tensors."""
    import torch

    sa, sb = ma.state_dict(), mb.state_dict()
    pairs = [(f"{n}", sa[n], sb[n]) for n in sa]
    pairs += [(f"grad {n}", p.grad, q.grad) for (n, p), q in zip(
        ma.named_parameters(), mb.parameters())]
    pairs += [(f"moment {i}", x, y) for i, (x, y) in enumerate(zip(
        oa.mu + oa.nu, ob.mu + ob.nu))]
    bad = [n for n, x, y in pairs if (x is None) != (y is None) or (
        x is not None and not torch.equal(x, y))]
    if bad or oa.count != ob.count:
        fail(f"{what}: captured state differs from eager ({len(bad)} "
             f"tensors: {bad[:4]}; counts {oa.count}, {ob.count})")
    return len(pairs)


def without_syncs(fn):
    """``fn()`` with every device synchronisation an error
    (``torch.cuda.set_sync_debug_mode``): no host read is left."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def peak_memory():
    """Peak device memory since the last reset: allocated to tensors, and
    reserved by the allocator (a graph's private pool keeps its freed
    intermediates reserved, where an eager step returns them)."""
    import torch

    return dict(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30)


def eager_and_captured(name, make, args_of, n, frames):
    """Phase 15's comparison for one path: ``make()`` a fresh step (its
    state made afresh from the same seed), ``n`` calls with the states
    carried (``args_of(previous output or None)``), eagerly and captured
    (the first call a warm-up, then the capture, then replays). Requires
    every output of every call bit for bit, one replay without a device
    synchronisation, and returns, for each mode, the ms a call after the
    first, frames/s, the profile of one more call (wall ms, device busy
    ms, idle share), peak GiB, and the steps' (eager, captured) objects."""
    import torch

    from rvt_tpu_torch.training import graphs

    res, outs, objs = {}, {}, {}
    for mode in ("eager", "captured"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = make()
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            got = [step(*args_of(None))]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n - 1):
                got.append(step(*args_of(got[-1])))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
            # the same calls in both modes (a train step's state moves)
            if mode == "captured":
                without_syncs(lambda: step(*args_of(got[-1])))
            else:
                step(*args_of(got[-1]))
            prof = profile_window(lambda: step(*args_of(got[-1])),
                                  f"{name} call ({mode})", top=6)
        res[mode] = dict(ms=ms, fps=frames / ms * 1e3, wall_ms=prof[0],
                         busy_ms=prof[1], idle=prof[2], **peak_memory())
        outs[mode], objs[mode] = got, step
    k = same_leaves(outs["captured"], outs["eager"], name)
    log(f"  {name}: {n} calls, {k} output tensors bit for bit, captured "
        "vs eager; a replay made no device synchronisation")
    return res, objs


def run_captured_path():
    """Phase 15: each path's step captured as a CUDA graph against the same
    step eager (``graphs.eager()``), from the same state, in one run: the
    eval step (4 windows), the raw step (1 + 21 calls), the train step
    (1 + 5 steps; then the parameters, BatchNorm buffers, gradients and
    moments), the per-step backbone's forward and backward (3 calls) and
    the Trainer with token masks (4 batches; its state after), all bit for
    bit, under cuDNN's deterministic algorithms (two eager steps would
    otherwise differ in its backward-filter sums); one replay of each
    without a device synchronisation. Prints ms a call, frames/s, the
    device busy time and idle share of one profiled call, and peak
    memory, captured beside eager. Returns {path: {mode: numbers}}."""
    import copy
    import tempfile

    import torch

    from rvt_tpu_torch.inference import make_raw_inference_step
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import fused_train_scan_backbone
    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import (make_eval_step, make_train_step,
                                             pad_ev_repr)
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        # eval: phase 4's cell
        cfg, model, ev, fv, first = eval_cell()
        bb = cfg.model.backbone

        def eval_args(prev):
            st = (zero_states(bb, BATCH, device="cuda") if prev is None
                  else prev.states)
            return st, ev, fv, first

        out["eval"], _ = eager_and_captured(
            "eval step", lambda: make_eval_step(model, cfg), eval_args,
            WINDOWS, BATCH * SEQ_LEN)
        del model, ev
        # raw: phase 5's cell
        cfg, model, frames, first = raw_cell()
        bb = cfg.model.backbone
        calls = iter(range(10 ** 9))

        def raw_args(prev):
            st = (zero_states(bb, BATCH, device="cuda") if prev is None
                  else prev[0])
            return (st, *frames[next(calls) % RAW_FRAMES], first)

        def make_raw():
            nonlocal calls
            calls = iter(range(10 ** 9))
            return make_raw_inference_step(model, cfg)

        out["raw"], _ = eager_and_captured("raw step", make_raw, raw_args,
                                           1 + RAW_CALLS, BATCH)
        del model, frames
        # train: phase 7's cell, each mode from a copy of one state
        cfg = gen1_base_train_cfg()
        bb = cfg.model.backbone
        base = gen1_base_model(cfg)
        batch = train_batch(cfg, "cuda")
        made = []

        def make_train():
            m = copy.deepcopy(base)
            made.append((m, make_optimizer(m.parameters(), cfg.training)))
            return make_train_step(m, cfg, made[-1][1])

        def train_args(prev):
            st = (zero_states(bb, BATCH, device="cuda") if prev is None
                  else prev[0])
            return (st, *batch)

        out["train"], _ = eager_and_captured(
            "train step", make_train, train_args, 1 + TRAIN_STEPS,
            BATCH * SEQ_LEN)
        (me, oe), (mc, oc) = made
        n = same_training_state(mc, oc, me, oe, "train step")
        log(f"  train step: after {1 + TRAIN_STEPS} + 2 steps, {n} tensors "
            "(parameters, BatchNorm buffers, gradients, moments) bit for "
            "bit, captured vs eager")
        del base, made, me, oe, mc, oc
        # per-step backbone: phase 8's forward and backward, captured
        model = gen1_base_model(cfg)
        ev_seq = pad_ev_repr(batch[0], bb.in_res_hw, torch.float32
                             ).transpose(0, 1)
        with torch.no_grad():
            _, st0 = fused_train_scan_backbone(
                model, ev_seq, zero_states(bb, BATCH, device="cuda"))
        params = [p for n, p in model.named_parameters()
                  if n.startswith("backbone.")]
        g = torch.Generator(device="cuda").manual_seed(6)
        weights = []

        def backbone_fb(ev_seq, states):
            model.zero_grad(set_to_none=True)
            feats, final = fused_train_scan_backbone(model, ev_seq, states,
                                                     per_step=True)
            outs = list(feats) + [t for hc in final for t in hc]
            if not weights:
                weights.extend(torch.randn(o.shape, generator=g,
                                           device="cuda") for o in outs)
            loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
            loss.backward()
            return ([o.detach() for o in outs],
                    [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params])

        out["per-step backbone"], _ = eager_and_captured(
            "per-step backbone forward and backward",
            lambda: graphs.CapturedStep(backbone_fb),
            lambda prev: (ev_seq, st0), 3, BATCH * SEQ_LEN)
        del model, ev_seq, st0
        # the Trainer with token masks, 4 batches, one state each mode
        cfg = gen1_base_train_cfg(enable_masking=True)
        items = trainer_batches(cfg)
        trainers, tr = {}, {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs_") as tmp:
            for mode in ("eager", "captured"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                trainer = Trainer(cfg, TrainerConfig(
                    max_steps=4, log_every_n_steps=1, ckpt_every_n_steps=100,
                    gradflow_every_n_steps=0,
                    detection_metrics_every_n_steps=0, prefetch_depth=2,
                    ckpt_dir=f"{tmp}/{mode}"), model=gen1_base_model(cfg))
                ctx = (graphs.eager() if mode == "eager"
                       else contextlib.nullcontext())
                with ctx:
                    trainer.fit(iter(items[:1]))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    last = trainer.fit(iter(items[1:]))
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / 3
                tr[mode] = dict(ms=ms, fps=BATCH * SEQ_LEN / ms * 1e3,
                                last=last, **peak_memory())
                trainers[mode] = trainer
            n = same_training_state(
                trainers["captured"].model, trainers["captured"].optimizer,
                trainers["eager"].model, trainers["eager"].optimizer,
                "trainer")
            lc, le = (tr[m].pop("last") for m in ("captured", "eager"))
            keys = [k for k in le if k != "train/frames_per_s"]
            if not keys or any(lc[k] != le[k] for k in keys):
                fail("trainer: the last step's metrics differ, captured vs "
                     "eager")
            log(f"  trainer: 4 batches with token masks, {n} tensors of "
                "state and the last step's metrics bit for bit, captured "
                "vs eager")
            args = (zero_states(cfg.model.backbone, BATCH, device="cuda"),
                    *trainers["captured"]._to_device(items[0]))
            without_syncs(lambda: trainers["captured"].train_step(*args))
            # one more step of each, profiled (the state compared above)
            for mode in ("eager", "captured"):
                with (graphs.eager() if mode == "eager"
                      else contextlib.nullcontext()):
                    prof = profile_window(
                        lambda: trainers[mode].train_step(*args),
                        f"trainer step ({mode}, masked)", top=6)
                tr[mode].update(wall_ms=prof[0], busy_ms=prof[1],
                                idle=prof[2])
        out["trainer"] = tr
        del trainers
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for path, r in out.items():
        e, c = r["eager"], r["captured"]
        log(f"captured vs eager, {path}: {c['ms']:.2f} vs {e['ms']:.2f} ms a "
            f"call ({c['fps']:.1f} vs {e['fps']:.1f} frames/s), "
            + (f"device busy {c['busy_ms']:.2f} vs {e['busy_ms']:.2f} ms, "
               f"idle share {c['idle']:.3f} vs {e['idle']:.3f}, "
               if "busy_ms" in c else "")
            + f"peak allocated {c['peak_gib']:.2f} vs {e['peak_gib']:.2f} "
            f"GiB, reserved {c['reserved_gib']:.2f} vs {e['reserved_gib']:.2f}"
            f" GiB; {CARD}")
    return out


DP_STEPS = 4  # phase 16's train steps a run: 1 warm-up call, 3 replays
F32_STEPS = 3  # the f32 leg's (b), (f)


def dp_steps(cfg, base, data, batch, dev, group, steps=DP_STEPS,
             **variant):
    """``steps`` train steps (captured on a card) of a copy of ``base`` on
    ``data`` (the global batch's tensors), the LSTM states carried, in
    ``group`` (None: no collective). Returns (model, optimizer, step,
    final states, each call's outputs, the reference the dp ranks are
    held to: each step's metrics, and the gradients and the state dict
    after step 1)."""
    import copy

    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_train_step

    model = copy.deepcopy(base)
    opt = make_optimizer(model.parameters(), cfg.training)
    step = make_train_step(model, cfg, opt, group=group, **variant)
    states = zero_states(cfg.model.backbone, batch, device=dev)
    outs, ref = [], {}
    for i in range(steps):
        outs.append(step(states, *data))
        states = outs[-1][0]
        if i == 0:
            ref["grads"] = {n: p.grad.detach().clone()
                            for n, p in model.named_parameters()}
            ref["state"] = {k: v.detach().clone()
                            for k, v in model.state_dict().items()}
    ref["metrics"] = [{k: float(v) for k, v in o[1].items()} for o in outs]
    return model, opt, step, states, outs, ref


def rotated_lanes_floor(cfg, base, data, batch, dev, ref):
    """The gradient's own spread: one process's eager step 1 on the
    global batch with its lanes rotated by half (the same function, its
    sums in another order) against ``ref``'s step 1. Returns the median
    and the worst of the leaves' max|err| over their max|ref|."""
    import torch

    from rvt_tpu_torch.training import graphs

    rotated = [torch.roll(d, batch // 2, 0) for d in data]
    with graphs.eager():
        got = dp_steps(cfg, base, rotated, batch, dev, None, 1)[5]
    rows = sorted(compare_rel_quiet(got["grads"][n], g)
                  for n, g in ref["grads"].items())
    return rows[len(rows) // 2], rows[-1]


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matmuls in f32 within this block, not TF32."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def dp_f32_leg(dev="cuda", size="base", hw=(240, 304), batch=BATCH,
               seq_len=SEQ_LEN):
    """(b) and (f)'s f32 leg: ``preset("gen1", size)`` as it ships (the
    module path in f32 at the train cell's width), random weights, the
    train cell's global batch. The train cell's bf16 step is chaotic in
    its gradient (``rotated_lanes_floor``: one process's step 1 with its
    lanes rotated moves the leaves by a median of a quarter of their
    max|ref|, SimOTA's picks flip); in f32 without TF32 (which rounds f32
    convolutions' inputs to 10 bits) by some 1e-5, so this leg holds the
    ranks' gradients. Returns the ranks' ``dp_train_steps`` kwargs and
    the one-rank reference: F32_STEPS eager steps with TF32 off, under
    the caller's cudnn.deterministic, with its floor."""
    import torch

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.training import graphs

    cfg = preset("gen1", size, **({} if size == "base" else dict(
        resolution_hw=hw, sequence_length=seq_len)))
    base = gen1_base_model(cfg, device=dev)
    arrays = train_arrays(cfg, batch, seq_len)
    data = [torch.from_numpy(a).to(dev) for a in arrays]
    with no_tf32(), graphs.eager():
        ref = dp_steps(cfg, base, data, batch, dev, None, F32_STEPS)[5]
        ref["floor"] = rotated_lanes_floor(cfg, base, data, batch, dev, ref)
    state = {k: v.cpu() for k, v in base.state_dict().items()}
    return dict(cfg=cfg, state=state, arrays=arrays, steps=F32_STEPS,
                tf32=False), ref


def run_multi_card_leg(cfg=None, base=None, ref=None, f32=None,
                       timeout=600):
    """Phase 16 (f): NCCL ranks, one a card: two, and every card when
    there are more. Each rank runs DP_STEPS + 5 steps on its lanes of the
    train cell's global batch captured, then the same steps eagerly
    (``graphs.eager()``) from the same state: the replays must equal the
    eager calls bit for bit over every step (``same_replays``), and the
    captured ranks are held as (b) holds the gloo ranks against ``ref``
    (the one-rank captured step, made here when None) and timed; then
    the f32 leg's ranks, captured, against its reference (``f32``: the
    pair ``dp_f32_leg`` returns, made here when None). Standalone on a
    machine with several cards: import this script, set ``CARD``,
    ``kernels.build_all()``, then ``run_multi_card_leg()``. Returns
    ({ranks: ms a step by step, captured}, problems)."""
    import tempfile

    import torch

    from rvt_tpu_torch.parallel import dryrun

    if cfg is None:
        cfg = gen1_base_train_cfg()
        base = gen1_base_model(cfg)
        data = train_batch(cfg, "cuda")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # as (a)
        try:
            ref = dp_steps(cfg, base, data, BATCH, "cuda", None)[5]
            ref["floor"] = rotated_lanes_floor(cfg, base, data, BATCH,
                                               "cuda", ref)
            f32 = dp_f32_leg()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        del data
    state = {k: v.cpu() for k, v in base.state_dict().items()}
    kw = dict(cfg=cfg, state=state, arrays=train_arrays(cfg),
              steps=DP_STEPS + 5)
    n_cards = torch.cuda.device_count()
    out, problems = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        for n in sorted({2, n_cards}):
            label = f"(f) {n} NCCL ranks, one a card"
            t0 = time.perf_counter()
            ranks = dryrun.spawn([("chip_smoke:dp_train_steps", kw),
                                  ("chip_smoke:dp_train_steps",
                                   dict(kw, eager=True)),
                                  ("chip_smoke:dp_train_steps", f32[0])],
                                 n, f"{tmp}/{n}", device="cuda",
                                 timeout=timeout)
            captured, eager, exact = zip(*ranks)
            problems += same_replays(label, captured, eager)
            problems += hold_dp_ranks(label + ", captured", captured[0],
                                      captured[1], ref, CELL_TOL)
            problems += hold_dp_ranks(label + ", f32 leg, captured",
                                      exact[0], exact[1], f32[1], F32_TOL)
            out[n] = [sum(x) / n for x in zip(*(r["ms"] for r in captured))]
            ms_eager = [sum(x) / n for x in zip(*(r["ms"] for r in eager))]
            log(f"{label}, {BATCH // n} lanes each: ms a step by step (the "
                f"ranks' mean; the first is the warm-up and capture), "
                f"captured {[round(x, 2) for x in out[n]]}, eager "
                f"{[round(x, 2) for x in ms_eager]}; the last 5 "
                f"{sum(out[n][-5:]) / 5:.2f} vs {sum(ms_eager[-5:]) / 5:.2f}"
                f" ms ({time.perf_counter() - t0:.1f} s with the ranks' "
                f"start); {CARD}")
    return out, problems


def same_replays(label, captured, eager):
    """(f)'s check of the replays: each rank's captured steps against the
    same steps run eagerly, bit for bit: every step's metrics and the
    final LSTM states on every rank, and on rank 0 the gradients of step
    1, the state dict after it and the final state dict. Returns what
    failed."""
    import torch

    bad = []
    for r, (c, e) in enumerate(zip(captured, eager)):
        steps = [i + 1 for i, (a, b) in enumerate(zip(c["metrics"],
                                                      e["metrics"]))
                 if a != b]
        if steps:
            bad.append(f"rank {r}: the metrics of steps {steps} differ")
        if not all(torch.equal(x, y) for hc, he in zip(c["states"],
                                                       e["states"])
                   for x, y in zip(hc, he)):
            bad.append(f"rank {r}: the final LSTM states differ")
    for what in ("grads", "state_1", "state"):
        a, b = captured[0][what], eager[0][what]
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        if diff:
            bad.append(f"rank 0: {len(diff)} tensors of {what} differ "
                       f"({diff[0]} first)")
    log(f"  {label}: captured vs eager over {len(captured[0]['metrics'])} "
        f"steps on {len(captured)} ranks, bit for bit: "
        + ("yes" if not bad else "; ".join(bad)))
    return [f"{label}, captured vs eager: {b}" for b in bad]


def dp_train_cfg(size, hw, seq_len):
    """Phase 16's train config: the train cell's (gen1 RVT-B on the train
    kernels) at ``size`` "base"; a CPU rehearsal's smaller preset at
    ``hw`` and ``seq_len``."""
    from dataclasses import replace

    from rvt_tpu_torch.config import preset

    if size == "base":
        return gen1_base_train_cfg()
    cfg = preset("gen1", size, resolution_hw=hw, sequence_length=seq_len)
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True)))


def nccl_ms(fn):
    """Device ms of one call of ``fn`` in kernels whose name holds
    "nccl" (torch.profiler), and their count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
    return sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows)


def dp_side_effects(run):
    """What a Trainer run wrote: checkpoint steps, the registry's
    checkpoint versions and aliases, code snapshots, metrics lines."""
    from pathlib import Path

    from rvt_tpu_torch.utils.artifacts import ArtifactRegistry

    run = Path(run)
    reg = ArtifactRegistry(run / "registry")
    return dict(
        steps=sorted(int(p.name) for p in (run / "steps").iterdir()),
        versions=[v["step"] for v in reg.versions("checkpoint")],
        last=reg.aliases("checkpoint").get("last"),
        code=len(reg.versions("checkpoint-code")),
        lines=[json.loads(x)["step"] for x in
               (run / "metrics.jsonl").read_text().splitlines()])


def run_dp_path(dev="cuda", size="base", hw=(240, 304), batch=BATCH,
                seq_len=SEQ_LEN, timeout=600):
    """Phase 16 (``dp_path_in``) in a temporary directory, removed
    after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        return dp_path_in(tmp, dev, size, hw, batch, seq_len, timeout)


def dp_path_in(tmp, dev, size, hw, batch, seq_len, timeout):
    """Phase 16: data parallelism (``parallel/``) on the train cell, its
    stores, ranks' logs and checkpoints under ``tmp``.
    (a) one rank over NCCL in this process: the dp train step, captured,
    bit for bit with the same step without a group over DP_STEPS steps
    (both variants the Trainer runs: the plain step, and the one with
    detections and parameter metrics): outputs, then parameters,
    BatchNorm buffers, gradients and moments; each timed (ms a step,
    device busy, idle share) with the NCCL kernels' share. (b) two
    ranks sharing the card over gloo (eager), 4 lanes each of the same
    global batch: the replicas and the ranks' metrics bit for bit after
    every step; step 1's loss parts and grad_norm and the BatchNorm
    buffers after it against (a)'s step on the global batch; then the
    f32 leg (``dp_f32_leg``), whose loss parts and grad_norm are held at
    every step and step 1's gradient leaves too (``hold_dp_ranks``). (c)
    two ranks running
    ``run_streaming_eval`` on their shards of phase 13's recordings: the
    merged metrics the same on both, equal bit for bit to one process
    scoring the two shards' frames in rank order, and within
    DP_EVAL_ATOL of one process's run over all recordings (whose frames
    come in another order: the protocol breaks ties between equal scores
    by it). (d) a two-rank ``Trainer.fit`` of
    2 steps, checkpoints every step: each written and published once.
    (e) ``dryrun_multichip(2)``. (f) with two cards or more, NCCL ranks
    one a card, their replays bit for bit with eager calls and held as
    (b) (``run_multi_card_leg``). Returns (numbers for the summary line,
    the dp step's launches a rank)."""
    import torch
    import torch.distributed as dist

    from rvt_tpu_torch.cli.validate import serve_fused_config
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.data.sequence import StreamView
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.evaluation.prophesee import PropheseeEvaluator
    from rvt_tpu_torch.ops import boxes
    from rvt_tpu_torch.parallel import dryrun
    from rvt_tpu_torch.parallel.mesh import init_process_group, make_mesh
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval

    on_card = dev == "cuda"
    res = {}
    cfg = dp_train_cfg(size, hw, seq_len)
    base = gen1_base_model(cfg, device=dev)
    arrays = train_arrays(cfg, batch, seq_len)
    data = [torch.from_numpy(a).to(dev) for a in arrays]
    variants = {"plain": {}, "detections + param metrics": dict(
        with_detections=True, with_param_metrics=True)}
    counters = all_counters() + (boxes.NMS_KEEP,)
    dp_counts = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as phase 15: bit for bit
    t_start = time.perf_counter()
    # (a) one rank over NCCL, captured, against the step without a group
    init_process_group(dev, init_method=f"file://{tmp}/store", rank=0,
                       world_size=1)
    try:
        mesh = make_mesh()
        log(f"(a) one rank, backend {mesh.backend}, world {mesh.world}")
        if on_card and mesh.backend != "nccl":
            fail(f"phase 16 (a): one rank took {mesh.backend}, not NCCL")
        for vname, kw in variants.items():
            runs = {}
            for mode in ("single", "dp"):
                if mode == "dp":
                    for c in counters:
                        c.reset()
                runs[mode] = dp_steps(cfg, base, data, batch, dev,
                                      mesh.group if mode == "dp" else None,
                                      **kw)
                if mode == "dp":
                    for c in counters:
                        dp_counts[c.name] = (dp_counts.get(c.name, 0)
                                             + c.launches)
            if vname == "plain":
                res["ref"] = runs["single"][5]
                res["ref"]["floor"] = rotated_lanes_floor(
                    cfg, base, data, batch, dev, res["ref"])
            (ms_, os_, ss, sts, outs_s, _), (md, od, sd, std, outs_d, _) = (
                runs["single"], runs["dp"])
            k = same_leaves(outs_d, outs_s, f"dp step ({vname})")
            n = same_training_state(md, od, ms_, os_, f"dp step ({vname})")
            log(f"  (a) {vname}: {DP_STEPS} steps, {k} output tensors and "
                f"{n} tensors of state bit for bit, one-rank dp vs no group")
            if on_card and vname == "plain":
                for mode, (model, opt, step, states, _, _) in runs.items():
                    t = {}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(5):
                        states = step(states, *data)[0]
                    torch.cuda.synchronize()
                    t["ms"] = (time.perf_counter() - t0) * 1e3 / 5
                    prof = profile_window(lambda: step(states, *data),
                                          f"train step ({mode}, phase 16)",
                                          top=6)
                    t.update(wall_ms=prof[0], busy_ms=prof[1], idle=prof[2])
                    if mode == "dp":
                        t["nccl_ms"], t["nccl_kernels"] = nccl_ms(
                            lambda: step(states, *data))
                    res[mode] = t
                s_, d_ = res["single"], res["dp"]
                log(f"(a) captured train step, one-rank dp vs no group: "
                    f"{d_['ms']:.2f} vs {s_['ms']:.2f} ms a step, device "
                    f"busy {d_['busy_ms']:.2f} vs {s_['busy_ms']:.2f} ms, "
                    f"idle share {d_['idle']:.3f} vs {s_['idle']:.3f}; "
                    f"collectives: {d_['nccl_kernels']} NCCL kernels "
                    f"{d_['nccl_ms']:.4f} ms "
                    f"({d_['nccl_ms'] / d_['busy_ms']:.2%} of busy), busy "
                    f"difference {d_['busy_ms'] - s_['busy_ms']:.3f} ms "
                    f"({(d_['busy_ms'] - s_['busy_ms']) / d_['busy_ms']:.2%})"
                    f"; {CARD}")
            del runs, ms_, os_, ss, md, od, sd, outs_s, outs_d
            if on_card:
                torch.cuda.empty_cache()
        f32 = dp_f32_leg(dev, size, hw, batch, seq_len)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    launched = {n: v for n, v in dp_counts.items() if v}
    log(f"(a) dp step launches, per rank over {DP_STEPS} + {DP_STEPS} "
        f"steps: {launched}")
    train_kernels = ("ln_rows", "gemm_bf16", "partition_attention",
                     "lstm_scan", "ln_rows_bwd", "gemm_bf16_wgrad",
                     "partition_attention_bwd", "lstm_scan_bwd",
                     "train_reduce", "nms_keep")
    missing = [n for n in train_kernels if not dp_counts.get(n)]
    if on_card and missing:
        fail(f"phase 16: the dp step launched no {missing}")

    # (b)-(d): two ranks sharing the card (gloo), in one spawn
    vcfg = with_conf(serve_fused_config(preset(
        "gen1", size, **({} if size == "base" else dict(
            resolution_hw=hw, sequence_length=seq_len)))), VAL_CONF)
    vmodel = gen1_base_model(vcfg, device=dev)
    views = [StreamView(r, vcfg.dataset.sequence_length)
             for r in memory_recordings(VAL_LENGTHS, VAL_BOXES, hw=hw)]
    one = run_streaming_eval(vmodel, vcfg, iter(EvalStreamScheduler(
        views, batch)), batch, device=dev)
    # the same frames as the two ranks score them: shard 0's, then 1's
    with recorded_evaluator() as made:
        for r in range(2):
            run_streaming_eval(vmodel, vcfg, iter(EvalStreamScheduler(
                views, batch, shard_index=r, num_shards=2)), batch,
                device=dev)
    in_rank_order = PropheseeEvaluator(vcfg.dataset.name,
                                       vcfg.dataset.downsample_by_factor_2)
    for ev in made:
        in_rank_order.extend_from_bytes(ev.state_bytes())
    in_rank_order = in_rank_order.evaluate_buffer(
        *vcfg.dataset.dataloading_hw)
    del views
    cpu_state = {k: v.cpu() for k, v in base.state_dict().items()}
    run_dir = f"{tmp}/trainer"
    scenarios = [
        ("chip_smoke:dp_train_steps", dict(cfg=cfg, state=cpu_state,
                                           arrays=arrays, steps=DP_STEPS)),
        ("chip_smoke:dp_train_steps", f32[0]),
        ("chip_smoke:dp_streaming_eval", dict(
            cfg=vcfg, state={k: v.cpu()
                             for k, v in vmodel.state_dict().items()},
            hw=hw, batch_size=batch)),
        ("chip_smoke:dp_trainer_fit", dict(
            cfg=cfg, state=cpu_state, n=2, batch=batch, seq_len=seq_len,
            trainer_kw=dict(max_steps=2, log_every_n_steps=1,
                            ckpt_every_n_steps=1, gradflow_every_n_steps=0,
                            prefetch_depth=0, ckpt_dir=run_dir,
                            artifact_dir=f"{run_dir}/registry")))]
    del vmodel
    t0 = time.perf_counter()
    ranks = dryrun.spawn(scenarios, 2, f"{tmp}/gloo", device=dev,
                         timeout=timeout)
    res["spawn_s"] = time.perf_counter() - t0
    (b0, e0, c0, d0), (b1, e1, c1, d1) = ranks
    problems = hold_dp_ranks("(b) two gloo ranks on one card", b0, b1,
                             res["ref"], CELL_TOL)
    problems += hold_dp_ranks("(b) two gloo ranks on one card, f32 leg",
                              e0, e1, f32[1], F32_TOL)
    res["gloo_ms"] = [sum(x) / 2 for x in zip(b0["ms"], b1["ms"])]
    log(f"(b) gloo, eager: ms a step by step (the ranks' mean; the first "
        f"is the warm-up) {[round(x, 2) for x in res['gloo_ms']]}; "
        f"{CARD}")
    # (c) the evaluator merge
    gap = max(abs(c0[k] - one[k]) for k in one)
    if not (c0 == in_rank_order and c1 == c0 and gap <= DP_EVAL_ATOL):
        fail(f"(c) merged metrics {c0} (rank 1: {c1}) against one process "
             f"scoring the shards in rank order {in_rank_order}, and its "
             f"run over all recordings {one}")
    log(f"(c) streaming eval on two shards of {len(VAL_LENGTHS)} "
        f"recordings: both ranks' merged metrics the same, equal bit for "
        f"bit to one process scoring the shards' frames in rank order (AP "
        f"{c0['AP']:.9g}); one process over all recordings, frames in its "
        f"own order: AP {one['AP']:.9g}, largest difference {gap:.3e} "
        f"(tolerance {DP_EVAL_ATOL})")
    # (d) rank-0 side effects
    se = dp_side_effects(run_dir)
    want = dict(steps=[1, 2], versions=[2], last=2, code=1, lines=[1, 2])
    if se != want or d0["last"].keys() != d1["last"].keys():
        fail(f"(d) two-rank Trainer side effects {se}, want {want}")
    if not (d0["replicas"] and d1["replicas"]):
        fail("(d) the Trainer's replicas differ after fit")
    log(f"(d) two-rank Trainer.fit, 2 steps, checkpoints every step: each "
        f"written and published once ({se}); replicas equal")
    log(f"phase 16 (b)-(d): one spawn of 2 ranks, {res['spawn_s']:.1f} s")
    # (e) the dry run
    t0 = time.perf_counter()
    res["dryrun"] = dryrun.dryrun_multichip(2, device=dev,
                                            workdir=f"{tmp}/dryrun",
                                            timeout=timeout)
    log(f"(e) {res['dryrun']} ({time.perf_counter() - t0:.1f} s)")
    # (f) NCCL ranks, one a card, where there are two cards or more
    n_cards = torch.cuda.device_count() if on_card else 0
    if n_cards >= 2:
        nccl, more = run_multi_card_leg(cfg, base, res["ref"], f32,
                                        timeout)
        res["nccl_ms"] = nccl
        problems += more
    else:
        log(f"(f) not run: {n_cards} card(s) here; two NCCL ranks need two "
            "cards (NCCL refuses two ranks on one card)")
    res["phase_s"] = time.perf_counter() - t_start
    log(f"phase 16: {res['phase_s']:.1f} s")
    if problems:
        fail("phase 16: " + "; ".join(problems))
    return res, dp_counts


# (c): one process's run over all recordings orders the frames otherwise;
# the random head's scores tie (bf16 logits), and the protocol ranks tied
# detections by buffer order (5.8e-6 apart on an H100 80GB HBM3, 700 W)
DP_EVAL_ATOL = 1e-4
# (b), (f), the train cell: phase 7 holds the loss parts at 1e-4,
# grad_norm at 2e-2 and each gradient leaf at 5e-2 of its max|ref| with
# the head fed identical features; here each process's cuDNN convolutions
# round the bf16 features of its lanes their own way and SimOTA's picks
# differ. The tolerances of the loss parts and grad_norm were set from
# these readings on H100 80GB HBM3 cards at 700 W: with two ranks 110 vs
# 108 foreground anchors (num_fg 1.9e-2 apart, the loss parts up to
# 5.7e-3, grad_norm 1.6e-3), with four 113 (num_fg 4.6e-2, grad_norm
# 5.6e-2). The gradient leaves are printed, not held: one process's step
# with its lanes rotated moves them about as far (``rotated_lanes_floor``,
# printed beside them), so no tolerance there tells a fault from
# rounding; the f32 leg holds them. A rank normalising by its own count or averaging the
# gradients (grad_norm off by the world's factor), local BatchNorm (the
# replicas differ) or rank-local loss parts (the ranks' metrics differ)
# fail these.
CELL_TOL = dict(parts=0.1, grad_norm=0.1, bn=2e-2, grads=None, steps=1)
# the f32 leg: tests/test_torch_modules.py's f32 tolerances (loss parts
# and grad_norm 1e-3 relative at every step, each gradient leaf 1e-3 of
# its max|ref|, buffers 1e-4)
F32_TOL = dict(parts=1e-3, grad_norm=1e-3, bn=1e-4, grads=1e-3,
               steps=F32_STEPS)


def hold_dp_ranks(label, r0, r1, ref, tol):
    """Two ranks' ``dp_train_steps`` results against the one-rank step on
    the global batch (``ref``), at the tolerances ``tol`` (CELL_TOL or
    F32_TOL). Every step: the replicas equal and the ranks' metrics
    equal. The first ``tol["steps"]`` steps: loss parts (with num_fg) and
    grad_norm within ``tol``'s relative tolerances. After step 1 (from
    the same state): the BatchNorm buffers (the batch moments of every
    rank) within ``tol["bn"]`` of max|ref| and, where ``tol["grads"]``
    is set, each gradient leaf within it of its max|ref|. The later
    steps' drift is printed. Returns what failed (printed first)."""
    bad = []
    if not (all(r0["replicas"]) and all(r1["replicas"])):
        bad.append(f"the replicas differ ({r0['replicas']})")
    if r0["metrics"] != r1["metrics"]:
        bad.append("the ranks report different metrics")
    errs = [{k: abs(m[k] - mr[k]) / max(abs(mr[k]), 1e-3)
             for k in LOSS_KEYS}
            for m, mr in zip(r0["metrics"], ref["metrics"])]
    for i, step_errs in enumerate(errs[:tol["steps"]]):
        for k, e in step_errs.items():
            t = tol["grad_norm"] if k == "grad_norm" else tol["parts"]
            if not e <= t:
                bad.append(f"step {i + 1} {k} {r0['metrics'][i][k]:.6g} vs "
                           f"one rank {ref['metrics'][i][k]:.6g} (relative "
                           f"{e:.3e}, tolerance {t})")
    if not all(math.isfinite(v) for m in r0["metrics"] for v in m.values()):
        bad.append("non-finite metrics")
    want = ref["state"]
    bn = max(compare_rel_quiet(r0["state_1"][n].to(v.device), v)
             for n, v in want.items()
             if n.endswith(("running_mean", "running_var")))
    if not bn <= tol["bn"]:
        bad.append(f"BatchNorm buffers after step 1 {bn:.3e} of max|ref| "
                   f"(tolerance {tol['bn']})")
    rows = sorted(((compare_rel_quiet(r0["grads"][n].to(g.device), g), n)
                   for n, g in ref["grads"].items()), reverse=True)
    over = [n for e, n in rows if tol["grads"] is not None
            and not e <= tol["grads"]]
    if over:
        bad.append(f"step 1's gradients: {len(over)} leaves over "
                   f"{tol['grads']} of max|ref| ({over[0]} first)")
    held = f" (steps 1-{tol['steps']})" if tol["steps"] > 1 else ""
    log(f"  {label}: replicas equal after each of {len(r0['replicas'])} "
        f"steps: {all(r0['replicas']) and all(r1['replicas'])}; step 1 "
        "against one rank on the global batch: " + ", ".join(
            f"{k} {r0['metrics'][0][k]:.6g} vs {ref['metrics'][0][k]:.6g} "
            f"({v:.3e})" for k, v in errs[0].items())
        + f" (tolerances {tol['parts']}, grad_norm {tol['grad_norm']}"
        f"{held}); gradients, {len(rows)} leaves: median "
        f"{rows[len(rows) // 2][0]:.3e} of max|ref|, worst "
        + "; ".join(f"{n} {e:.3e}" for e, n in rows[:3])
        + "; worst by part " + ", ".join(
            f"{part} {max(e for e, n in rows if n.startswith(part)):.3e}"
            for part in ("backbone", "fpn", "yolox_head"))
        + (f" (tolerance {tol['grads']} each)" if tol["grads"] is not None
           else " (printed, not held)")
        + "; one process with its lanes rotated: median "
        f"{ref['floor'][0]:.3e}, worst {ref['floor'][1]:.3e}"
        + f"; after it BatchNorm buffers {bn:.3e} of max|ref| (tolerance "
        f"{tol['bn']}); later steps, relative: " + "; ".join(
            f"step {i + 2} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
            for i, e in enumerate(errs[1:])))
    return [f"{label}: {b}" for b in bad]


LOSS_KEYS = ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg",
             "grad_norm")


# -- phase 16's rank scenarios: the ranks (processes of
# rvt_tpu_torch.parallel.dryrun) import this script and call each as
# fn(mesh, device, **kwargs)


def dp_rank_model(cfg, state, device, mesh):
    """The detector of ``cfg`` with ``state``, broadcast from rank 0."""
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.parallel.mesh import module_tensors, replicate_tree

    model = init_detector(cfg.model, seed=0, device=device)
    model.load_state_dict(state, strict=True)
    replicate_tree(mesh, module_tensors(model))
    return model


def dp_train_steps(mesh, device, cfg, state, arrays, steps, eager=False,
                   tf32=True):
    """``steps`` data-parallel train steps of the model ``state`` on this
    rank's lanes of the global batch ``arrays``, the LSTM states carried,
    under cudnn.deterministic (without ``tf32``: f32 convolutions and
    matmuls in f32): captured over NCCL (with ``eager``, every call eager
    under ``graphs.eager()``, the replays' bit-for-bit reference), eager
    over gloo. Returns each step's metrics, wall ms
    and whether the replicas were bit for bit equal after it, and this
    rank's final LSTM states; rank 0 also the gradients and the state
    dict after step 1, and the final state dict."""
    import torch

    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.parallel.mesh import module_tensors, same_on_all_ranks
    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_train_step

    torch.backends.cudnn.deterministic = True  # as (a)
    model = dp_rank_model(cfg, state, device, mesh)
    opt = make_optimizer(model.parameters(), cfg.training)
    step = make_train_step(model, cfg, opt, group=mesh.group)
    lanes = mesh.lanes(arrays[0].shape[0])
    data = [torch.from_numpy(a[lanes]).to(device) for a in arrays]
    states = zero_states(cfg.model.backbone, lanes.stop - lanes.start,
                         device=device)
    on_card = device.type == "cuda"
    res = dict(metrics=[], ms=[], replicas=[])
    with contextlib.ExitStack() as modes:
        if eager:
            modes.enter_context(graphs.eager())
        if not tf32:
            modes.enter_context(no_tf32())
        for i in range(steps):
            if on_card:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            states, metrics = step(states, *data)
            if on_card:
                torch.cuda.synchronize(device)
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["metrics"].append({k: float(v) for k, v in metrics.items()})
            res["replicas"].append(same_on_all_ranks(
                mesh, module_tensors(model)))
            if i == 0 and mesh.is_main:
                # copies: the gradients are views of the optimizer's flat
                # buffer, which the next step overwrites
                res["grads"] = {n: p.grad.to("cpu", copy=True)
                                for n, p in model.named_parameters()}
                res["state_1"] = {k: v.to("cpu", copy=True)
                                  for k, v in model.state_dict().items()}
    res["states"] = [tuple(x.cpu() for x in hc) for hc in states]
    if mesh.is_main:
        res["state"] = {k: v.cpu() for k, v in model.state_dict().items()}
    return res


def dp_streaming_eval(mesh, device, cfg, state, hw, batch_size):
    """``run_streaming_eval`` over this rank's shard of phase 13's
    recordings at ``hw`` (``EvalStreamScheduler`` with
    ``shard_index=rank, num_shards=world``); the merged metrics."""
    from rvt_tpu_torch.data.sequence import StreamView
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval

    model = dp_rank_model(cfg, state, device, mesh)
    views = [StreamView(r, cfg.dataset.sequence_length)
             for r in memory_recordings(VAL_LENGTHS, VAL_BOXES, hw=hw)]
    sched = EvalStreamScheduler(views, batch_size, shard_index=mesh.rank,
                                num_shards=mesh.world)
    return run_streaming_eval(model, cfg, iter(sched), batch_size,
                              device=device)


def dp_trainer_fit(mesh, device, cfg, state, n, batch, seq_len,
                   trainer_kw):
    """``Trainer.fit`` over ``trainer_batches(cfg, n, batch, seq_len)``
    without token masks, with ``TrainerConfig(**trainer_kw)``,
    data-parallel over the ranks (the Trainer broadcasts the replicas);
    the last logged metrics and whether the replicas, with the
    optimizer's moments, are equal after."""
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.parallel.mesh import module_tensors, same_on_all_ranks
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    model = init_detector(cfg.model, seed=0, device=device)
    model.load_state_dict(state, strict=True)
    trainer = Trainer(cfg, TrainerConfig(**trainer_kw), model=model,
                      device=device)
    last = trainer.fit(iter(trainer_batches(cfg, n, batch, seq_len,
                                            masks=False)))
    return dict(last=last, replicas=same_on_all_ranks(
        mesh, module_tensors(trainer.model) + trainer.optimizer.mu
        + trainer.optimizer.nu))


# the kernels of csrc/ln_rows.cu and csrc/train_reduce.cu, whose template
# instances the profile lists apart
PROFILE_FAMILIES = {"ln_rows": ("ln_rows_kernel", "ln_rows_wide_kernel"),
                    "train_reduce": ("colsum_kernel", "ls_bwd_kernel")}


def profile_window(fn, what, top=14):
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    and the device's idle share of the call's wall time. Returns (wall ms,
    device busy ms, idle share)."""
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
    fams = {k: [(us, n) for key, us, n in rows
                if any(f"::{name}<" in key for name in names)]
            for k, names in PROFILE_FAMILIES.items()}
    log("  device time by kernel, all its instances: " + "; ".join(
        f"{k} {sum(us for us, _ in v) / 1e3:.3f} ms x{sum(n for _, n in v)}"
        for k, v in fams.items()))
    host = [(e.key, e.self_cpu_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host.sort(key=lambda r: -r[1])
    log(f"  host: {sum(r[1] for r in host) / 1e3:.2f} ms in operators "
        f"(profiled, so inflated); largest:")
    for key, us, n in host[:8]:
        log(f"  {us / 1e3:9.3f} ms host  x{n:<4d} {key[:90]}")
    return wall_us / 1e3, busy / 1e3, 1 - busy / wall_us


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
    check_gemm_edges()
    check_attention_lstm_edges()
    recs["stacked_histogram"] = check_voxelizer()
    recs["nms_keep"] = check_nms_keep()
    recs["window_s2d"] = check_window_s2d()
    recs["bn_act"] = check_bn_act()
    check_train_kernels(recs)
    log(f"LSTM yardstick dtypes: {LSTM_LIB}")
    fps, mfu, counts = run_main_path()
    raw_fps, raw_mfu, raw_counts = run_raw_path()
    torch.cuda.empty_cache()
    t_ms, t_fps, t_mfu, t_peak, t_counts = run_train_path()
    torch.cuda.empty_cache()
    s_counts = run_step_backbone_path(recs)
    torch.cuda.empty_cache()
    tr_ms, tr_fps, tr_counts = run_trainer_path()
    torch.cuda.empty_cache()
    sm_ms, _ = run_small_train_path()
    torch.cuda.empty_cache()
    sh = run_shipped_preset()
    torch.cuda.empty_cache()
    val, val_counts = run_validation_path(counts)
    torch.cuda.empty_cache()
    cli, cli_counts = run_train_cli_path()
    torch.cuda.empty_cache()
    cap = run_captured_path()
    torch.cuda.empty_cache()
    dp, dp_counts = run_dp_path()
    # the calls each record timed per step must be the launches the path
    # made per step (eval: 4 windows; raw: 1 + 21 calls; train: 1 + 5;
    # per-step train: one forward and backward; trainer: 4 + 1 + 1)
    steps = {"eval step": WINDOWS, "raw step": 1 + RAW_CALLS,
             "train step": 1 + TRAIN_STEPS, "per-step train": 1,
             "trainer": 6}
    for name, rec in recs.items():
        by_path = {"eval step": counts.get(name, 0),
                   "raw step": raw_counts.get(name, 0),
                   "train step": t_counts.get(name, 0),
                   "per-step train": s_counts.get(name, 0),
                   "trainer": tr_counts.get(name, 0),
                   "validate": val_counts.get(name, 0),
                   "train cli": cli_counts.get(name, 0),
                   "dp, per rank": dp_counts.get(name, 0)}
        rec.d["launches"] = sum(by_path.values())
        rec.d["launches_by_path"] = by_path
        for path, q in rec.paths.items():
            if q["launches"] * steps[path] != by_path[path]:
                fail(f"{name}: {q['launches']} launches per {path} timed, "
                     f"{by_path[path] / steps[path]:g} made")
    log_lstm_stages()
    log(f"card: {card}; eval step {fps:.1f} frames/s, MFU {mfu:.2f}%; "
        f"raw step {raw_fps:.1f} frames/s, MFU {raw_mfu:.2f}%; train step "
        f"{t_ms:.2f} ms, {t_fps:.1f} frames/s, MFU {t_mfu:.2f}%, peak "
        f"{t_peak:.2f} GiB; trainer {tr_ms:.2f} ms per step, "
        f"{tr_fps:.1f} frames/s; gen1 RVT-S train step {sm_ms:.2f} ms; "
        f"shipped gen1 RVT-B (f32, modules) eval {sh['fps']:.1f} frames/s, "
        f"train {sh['ms']:.2f} ms per step, peak {sh['peak']:.2f} GiB; "
        f"validation loop {val['loop_fps']:.1f} frames/s (the eval step "
        f"{fps:.1f}), shipped preset {val['shipped_fps']:.1f}; train "
        f"cli: loader {cli['loader_fps'][0]:.1f} frames/s serially, "
        f"{cli['loader_fps'][1]:.1f} with 2 threads, shipped preset "
        f"{cli['shipped_ms'][0]:.2f} ms a step from the scheduler, "
        f"{cli['shipped_ms'][1]:.2f} pre-stacked, kernels "
        f"{cli['kernels_ms'][0]:.2f}, {cli['kernels_ms'][1]:.2f} with 2 "
        f"workers, {cli['kernels_ms'][2]:.2f} pre-stacked, "
        f"native_lib {'loaded' if cli['native'] else 'not loaded'}; "
        "captured vs eager ms a call: " + ", ".join(
            f"{k} {v['captured']['ms']:.2f} vs {v['eager']['ms']:.2f}"
            for k, v in cap.items())
        + f"; dp train step, one NCCL rank {dp['dp']['ms']:.2f} ms vs "
        f"{dp['single']['ms']:.2f} without a group, two gloo ranks "
        f"{dp['gloo_ms'][-1]:.2f}; {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": [r.d for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Live detection from event cameras: one 50 ms bin a call for each of B
camera lanes, calls back to back (a closed loop).

Each lane's events a call: a count uniform in ``events`` (padded to N),
half of them uniform over the sensor and half in 1-4 Gaussian blobs of
the lane (centres drifting from call to call), polarity 50/50, times
sorted within the bin. A pool of distinct calls sits in pinned host
memory; each call copies its arrays to the card, runs the captured raw
step (``inference.py:make_raw_inference_step``: the voxelizer, the
detector at T = 1, NMS) and copies its detections back to pinned host
memory. The call's latency is from handing over its host events to its
detections in host memory. Each lane restarts every ``restart_calls``
calls (a range, drawn per restart); every lane restarts at the first
timed call, so that the reference follows it from zero states.

The check runs the reference on a sample of the window's calls, from
the states the program carried into each: the plain voxelizer, the
detector at T = 1, the postprocess; it compares the new states (which the
voxelized frame reaches through every stage), the head's outputs (the
neck and head), and the detections.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core.driver import (BaseDriver, add, channel_gap, det_gap,
                                   fold, host_dets, stage_mismatch,
                                   states_gap)
from benchmark.core.trace import sync
from benchmark.counts import bounds, flops
from benchmark.reference import post, rvt
from benchmark.reference.precision import F32, FP8, no_tf32


class Driver(BaseDriver):
    def setup(self, seconds: float) -> None:
        from rvt_tpu_torch.inference import make_raw_inference_step
        from rvt_tpu_torch.models.backbone import zero_states

        from benchmark.core.port import port_config, port_model

        A, tp, dev = self.A, self.tp, self.device
        self.B = tp["lanes"]
        self.frames_per_call = self.B
        self.flops_per_call = flops.raw_call(A, self.B)
        self.pc = port_config(self.cfg, stem_s2d=False)
        self.sd = self.weights()
        self.model = port_model(self.pc, self.sd, dev)
        self.model.register_forward_hook(self._keep_preds)
        self.pool = self._calls()
        n_max = int(seconds * 20000) + 64
        self.is_first = self._restarts(n_max).to(dev)
        self.step = make_raw_inference_step(self.model, self.pc)
        self.zero = lambda: zero_states(self.pc.model.backbone, self.B,
                                        device=dev)
        pin = dev.type == "cuda"
        md = self.cfg["postprocess"]["max_detections"]
        self.host_dets = torch.empty(self.B, md, 7, pin_memory=pin)
        self.host_valid = torch.empty(self.B, md, dtype=torch.bool,
                                      pin_memory=pin)
        self.states = self.zero()
        self.kept, self.samples = {}, set()
        for i in range(4):  # the eager call and the capture, then replays
            self.call(i, warm=True)
            if i == 1:
                sync(dev)
                t0 = time.perf_counter()
        pace = (time.perf_counter() - t0) / 2
        self.samples = set(self.sample_calls(int(seconds / max(pace, 1e-5)),
                                             tp["sample"]))
        self.states = self.zero()
        self.kept, self.latencies = {}, []

    def _calls(self):
        """The pool: per call x, y, p, t [B, N] and counts [B], int32, in
        pinned host memory, made on the card from the seed."""
        tp, dev = self.tp, self.device
        H, W = self.A["resolution_hw"]
        N, B = tp["events_padded"], self.B
        lo, hi = tp["events"]
        g = self.gen(2)
        nblobs = torch.randint(1, 5, (B,), generator=g, device=dev)
        centre = torch.rand(B, 4, 2, generator=g, device=dev) \
            * torch.tensor([W, H], device=dev)
        sigma = 5 + 25 * torch.rand(B, 4, generator=g, device=dev)
        pool = []
        for _ in range(tp["pool_calls"]):
            counts = torch.randint(lo, hi + 1, (B,), generator=g, device=dev,
                                   dtype=torch.int32)
            centre = centre + 4 * torch.randn(B, 4, 2, generator=g,
                                              device=dev)
            blob = torch.randint(0, 4, (B, N), generator=g, device=dev) \
                % nblobs[:, None]
            c = torch.gather(centre, 1, blob[..., None].expand(-1, -1, 2))
            s = torch.gather(sigma, 1, blob)[..., None]
            near = c + s * torch.randn(B, N, 2, generator=g, device=dev)
            far = torch.rand(B, N, 2, generator=g, device=dev) \
                * torch.tensor([W, H], device=dev)
            in_blob = torch.rand(B, N, 1, generator=g, device=dev) < 0.5
            xy = torch.where(in_blob, near, far).floor()
            xy[..., 0].clamp_(0, W - 1)
            xy[..., 1].clamp_(0, H - 1)
            p = torch.randint(0, 2, (B, N), generator=g, device=dev,
                              dtype=torch.int32)
            live = torch.arange(N, device=dev)[None] < counts[:, None]
            t = torch.randint(0, 50_000, (B, N), generator=g, device=dev)
            # the live events' times sorted, zero past the count
            t = torch.sort(torch.where(live, t, 1 << 30), dim=1).values
            arrays = [torch.where(live, a, torch.zeros_like(a)).to(
                torch.int32) for a in (xy[..., 0], xy[..., 1], p, t)]
            host = [a.cpu().pin_memory() if dev.type == "cuda" else a.cpu()
                    for a in arrays + [counts]]
            pool.append(host)
        return pool

    def _restarts(self, n: int) -> torch.Tensor:
        lo, hi = self.tp["restart_calls"]
        first = np.zeros((n, self.B), bool)
        first[0] = True
        for b in range(self.B):
            at = int(self.rng.integers(lo, hi + 1))
            while at < n:
                first[at, b] = True
                at += int(self.rng.integers(lo, hi + 1))
        return torch.from_numpy(first)

    def bound_per_call(self) -> float:
        events = np.mean([float(c[4].sum()) for c in self.pool])
        return bounds.raw_call(self.A, self.B, events, self.A["bins"])

    def _keep_preds(self, module, inputs, out) -> None:
        """The detector's forward hook: its head outputs. It runs when the
        step runs as Python (the eager call, the capture), not at a
        replay; the captured tensor then holds each replay's outputs."""
        self.preds = out[0]

    def call(self, i: int, warm: bool = False) -> None:
        host = self.pool[i % len(self.pool)]
        first = self.is_first[i]
        states_in = self.states
        t0 = time.perf_counter()
        ev = [h.to(self.device, non_blocking=True) for h in host]
        states, dets, valid = self.step(states_in, *ev, first)
        self.host_dets.copy_(dets, non_blocking=True)
        self.host_valid.copy_(valid, non_blocking=True)
        sync(self.device)
        if not warm:
            self.latencies.append(time.perf_counter() - t0)
            self.attempted += 1
            if not torch.isfinite(self.host_dets).all():
                self.failed += 1
        self.states = states
        if i in self.samples and not warm:
            self.kept[i] = dict(states_in=states_in, ev=i % len(self.pool),
                                first=first, states=states,
                                preds=self.preds.clone(),
                                dets=self.host_dets.clone(),
                                valid=self.host_valid.clone())

    def finish(self) -> None:
        pass

    def release(self) -> None:
        super().release()
        self.states = self.preds = None

    # ------------------------------------------------------------ check

    def _post(self, preds, nms=None):
        pp = self.cfg["postprocess"]
        return post.postprocess(preds, self.A["num_classes"],
                                pp["confidence_threshold"],
                                pp["nms_threshold"] if nms is None else nms,
                                pp["max_detections"])

    def _reference(self, k: dict, prec):
        """The plain voxelizer, the detector at T = 1 and the postprocess
        from the call's events and the states carried into it: (states,
        head outputs, detections)."""
        A = self.A
        H, W = A["resolution_hw"]
        ev = [h.to(self.device) for h in self.pool[k["ev"]]]
        frames = post.stacked_histogram(*ev, A["bins"], H, W)
        x = rvt.pad_events(frames.permute(0, 2, 3, 1), A)[None]
        states = rvt.reset(k["states_in"], k["first"])
        feats, st = rvt.backbone_window(self.sd, A, x, states, prec)
        bn = rvt.BatchNorms(self.sd, train=False)
        preds = rvt.detect([f[0] for f in feats], self.sd, A, bn, prec)
        return st, preds, self._post(preds)

    def check(self, control: bool = False):
        """Per sampled call: the states, the head outputs, the detections
        against the reference's own (``det_gap``), and the postprocess
        stage by itself: the reference's postprocess of the program's own
        head outputs against the detections that reached the host
        (``nms_mismatch``: exact, but that an IoU within rounding of the
        threshold may go either way; the control has no such reading).
        Returns (readings, control readings or None), each the worst over
        the calls, the detections' pooled."""
        A = self.A
        worst, cworst = {}, ({} if control else None)
        miss, cmiss, mismatch = [0, 0], [0, 0], [0, 0]
        nms = self.cfg["postprocess"]["nms_threshold"]

        def head(p):
            return rvt.raw_head_outputs(p, A)
        with torch.no_grad(), no_tf32():
            for i in sorted(self.kept):
                k = self.kept[i]
                st, preds, dets = self._reference(k, F32)
                got = host_dets(k["dets"], k["valid"])
                add(mismatch, stage_mismatch(self._post, k["preds"],
                                             k["dets"], k["valid"], nms))
                add(miss, det_gap(got, dets))
                fold(worst, {"state_gap": states_gap(k["states"], st),
                             "head_gap": channel_gap(head(k["preds"]),
                                                     head(preds))})
                if control:
                    c_st, c_preds, c_dets = self._reference(k, FP8)
                    add(cmiss, det_gap(c_dets, dets))
                    fold(cworst, {"state_gap": states_gap(c_st, st),
                                  "head_gap": channel_gap(head(c_preds),
                                                          head(preds))})
        worst["nms_mismatch"] = float(mismatch[0])
        worst["det_gap"] = miss[0] / max(miss[1], 1)
        if control:
            cworst["det_gap"] = cmiss[0] / max(cmiss[1], 1)
        self.look = {"detections": miss[1], "unmatched": miss[0],
                     "nms_near_threshold": mismatch[1]}
        return worst, cworst


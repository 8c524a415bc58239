"""Streaming evaluation windows: the device half of validation.

B lanes x T frames a window, windows back to back with the LSTM states
carried. A pool of distinct stored uint8 windows ([B, T, 2 x bins, H, W],
the layout the recordings keep) is made from the seed on the card at
set-up. Each call lays a window out on the card
(``training/feed.py:window_input``: the channel-last permute and the s2d
blocking), runs the captured eval step (``training/step.py:
make_eval_step``) and starts the copy of its detections to pinned host
memory (``training/evaluator_loop.py:fetch_outputs``); it then waits for
the previous window's detections, as the validation loop does. Labelled
frames every ``label_every`` frames at a phase drawn per lane and window;
each lane restarts (``is_first_sample``) with probability ``restart_p``
a window, and every lane restarts at the first timed window, so that the
reference follows it from zero states.

The check runs the reference on a sample of the window's calls, from
the states the program carried into each: the final states, the head's
outputs, the frames gathered and the detections; and, as a stage by
itself, the reference's postprocess of the program's own head outputs
against the detections that reached the host.
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
        from rvt_tpu_torch.models.backbone import zero_states
        from rvt_tpu_torch.training.evaluator_loop import fetch_outputs
        from rvt_tpu_torch.training.feed import window_input
        from rvt_tpu_torch.training.step import make_eval_step

        from benchmark.core.port import port_config, port_model

        A, tp, dev = self.A, self.tp, self.device
        self.B, self.T = tp["lanes"], A["sequence_length"]
        self.K = A["max_labeled_frames"]
        self.frames_per_call = self.B * self.T
        self.flops_per_call = flops.eval_window(A, self.B, self.T, self.K)
        self.pc = port_config(self.cfg, stem_s2d=True)
        self.sd = self.weights()
        self.model = port_model(self.pc, self.sd, dev)
        self._window_input = window_input
        self._fetch = fetch_outputs
        self.pool = self._windows()
        n_max = int(seconds * 2000) + 64
        first = torch.from_numpy(self.rng.random((n_max, self.B))
                                 < tp["restart_p"])
        first[0] = True
        self.is_first = first.to(dev)
        phase = self.rng.integers(0, tp["label_every"], (n_max, self.B))
        t = torch.arange(self.T)[None, None]
        self.frame_valid = ((t + torch.from_numpy(phase)[..., None])
                            % tp["label_every"] == tp["label_every"] - 1
                            ).to(dev)
        self.step = make_eval_step(self.model, self.pc)
        self.states = zero_states(self.pc.model.backbone, self.B, device=dev)
        self.pending = None
        self.kept = {}
        self.samples = set()
        # the warm-up: the eager call and the capture, then replays
        for i in range(4):
            self.call(i, warm=True)
            if i == 1:
                sync(dev)
                t0 = time.perf_counter()
        self.finish()
        pace = (time.perf_counter() - t0) / 2
        self.samples = set(self.sample_calls(int(seconds / max(pace, 1e-4)),
                                             tp["sample"]))
        self.states = zero_states(self.pc.model.backbone, self.B, device=dev)
        self.kept = {}

    def _windows(self):
        """The pool. Each lane of each window has its own density of
        events, the same set of densities for every seed (evenly over
        ``density``), dealt out in an order drawn from the seed."""
        tp, A, dev = self.tp, self.A, self.device
        H, W = A["resolution_hw"]
        C = 2 * A["bins"]
        g = self.gen(1)
        n = tp["pool_windows"] * self.B
        lo, hi = tp["density"]
        dens = lo + (hi - lo) * (torch.randperm(n, generator=g, device=dev)
                                 .float() + 0.5) / n
        pool = []
        for w in range(tp["pool_windows"]):
            ev = torch.empty(self.B, self.T, C, H, W, dtype=torch.uint8,
                             device=dev)
            for b in range(self.B):
                v = torch.randint(0, tp["max_count"], (self.T, C, H, W),
                                  generator=g, device=dev, dtype=torch.uint8)
                keep = torch.rand((self.T, C, H, W), generator=g,
                                  device=dev) < dens[w * self.B + b]
                ev[b] = v * keep
            pool.append(ev)
        return pool

    def bound_per_call(self) -> float:
        return bounds.eval_window(self.A, self.B, self.T, self.K)

    def call(self, i: int, warm: bool = False) -> None:
        ev = self.pool[i % len(self.pool)]
        first, fv = self.is_first[i], self.frame_valid[i]
        states_in = self.states
        x = self._window_input(ev, True, tuple(self.A["in_res_hw"]), True)
        out = self.step(states_in, x, fv, first)
        self.states = out.states
        fetch = self._fetch((out.dets, out.det_valid, out.frame_idx,
                             out.gval), self.device)
        if i in self.samples and not warm:
            self.kept[i] = dict(states_in=states_in, ev=i % len(self.pool),
                                first=first, fv=fv, states=out.states,
                                preds=out.preds)
        self._drain()
        self.pending = (i, fetch, warm)
        if not warm:
            self.attempted += 1

    def _drain(self) -> None:
        if self.pending is None:
            return
        i, fetch, warm = self.pending
        dets, valid, frame_idx, gval = fetch()
        if not warm and not np.isfinite(dets).all():
            self.failed += 1
        if i in self.kept:
            self.kept[i].update(dets=dets, valid=valid, frame_idx=frame_idx,
                                gval=gval)
        self.pending = None

    def finish(self) -> None:
        self._drain()

    def release(self) -> None:
        super().release()
        self.states = None

    # ------------------------------------------------------------ check

    def _post(self, preds, nms=None):
        pp = self.cfg["postprocess"]
        return post.postprocess(preds, self.A["num_classes"],
                                pp["confidence_threshold"],
                                pp["nms_threshold"] if nms is None else nms,
                                pp["max_detections"])

    def _reference(self, k: dict, prec):
        """The reference's window from the stored window and the states
        carried into it: (final states, head outputs of the gathered
        frames, their detections, the frames gathered)."""
        A = self.A
        ev = self.pool[k["ev"]].permute(0, 1, 3, 4, 2)
        x = rvt.pad_events(ev, A).transpose(0, 1)
        states = rvt.reset(k["states_in"], k["first"])
        feats, st = rvt.backbone_window(self.sd, A, x, states, prec)
        idx, gval = rvt.gather_labelled(k["fv"], self.K)
        bn = rvt.BatchNorms(self.sd, train=False)
        preds = rvt.detect(rvt.gathered(feats, idx), self.sd, A, bn, prec)
        return st, preds, self._post(preds), idx

    def check(self, control: bool = False):
        """Per sampled window: the final states, the head's outputs on the
        gathered frames, the frames gathered, the labelled frames'
        detections against the reference's own (``det_gap``), and the
        postprocess stage by itself: the reference's postprocess of the
        program's own head outputs against the detections that reached
        the host (``nms_mismatch``: exact, but that an IoU within rounding of
        the threshold may go either way; with the frames gathered; the
        control has no such reading). Returns (readings, control readings
        or None), each the worst over the windows, the detections'
        pooled."""
        A = self.A
        worst, cworst = {}, ({} if control else None)
        miss, cmiss, mismatch = [0, 0], [0, 0], [0, 0]
        nms = self.cfg["postprocess"]["nms_threshold"]

        def head(p):
            return rvt.raw_head_outputs(p, A)
        with torch.no_grad(), no_tf32():
            for i in sorted(self.kept):
                k = self.kept[i]
                st, preds, dets, idx = self._reference(k, F32)
                lab = torch.as_tensor(k["gval"]).reshape(-1).tolist()
                F = len(lab)
                dets_f = k["dets"].reshape(F, -1, 7)
                valid_f = k["valid"].reshape(F, -1)
                got = host_dets(dets_f, valid_f)
                if not torch.equal(torch.as_tensor(k["frame_idx"]),
                                   idx.cpu()):
                    mismatch[0] += 1
                on = torch.as_tensor(lab)
                add(mismatch, stage_mismatch(
                    self._post, k["preds"][on.to(k["preds"].device)],
                    dets_f[on.numpy()], valid_f[on.numpy()], nms))
                add(miss, det_gap(labelled(got, lab), labelled(dets, lab)))
                fold(worst, {"state_gap": states_gap(k["states"], st),
                             "head_gap": channel_gap(head(k["preds"]),
                                                     head(preds))})
                if control:
                    c_st, c_preds, c_dets, _ = self._reference(k, FP8)
                    add(cmiss, det_gap(labelled(c_dets, lab),
                                       labelled(dets, lab)))
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


def labelled(frames, lab):
    """The gathered frames that are labelled."""
    return [f for f, keep in zip(frames, lab) if keep]

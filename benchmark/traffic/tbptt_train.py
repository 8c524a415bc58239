"""TBPTT training: one step a window of B lanes x T frames, steps back to
back with the LSTM states carried (cut at each window) and lanes
restarting.

A pool of distinct windows sits on the card, made from the seed: uint8
event counts [B, T, H, W, 2 x bins] at the sensor's resolution, labelled
frames every ``label_every`` frames at a phase drawn per lane and window,
1-12 boxes of the dataset's classes a labelled frame (sides in
``box_side`` pixels), padded to M. Each call is the captured train step
(``training/step.py:make_train_step`` with the port's ``OneCycleAdamW``:
the backbone scan with its gradients, the labelled frames' PAFPN and
head, SimOTA and the YOLOX loss, the backward, the clip, AdamW, the
BatchNorm updates) on the next window of the pool.

Set-up builds the step with its model and optimizer and drives it
through its first three steps, on three different windows, through the
same call the window makes; the window goes on from step four. The check
runs the reference through the same three steps from the same weights
and compares each step's loss and gradient norm, each leaf's first
gradient as the optimizer took it (from its first moment after step
one), each leaf's change over the three steps, BatchNorm's buffers'
change, and the final states.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.core.driver import (BaseDriver, leaf_gaps, norm_gap,
                                   states_gap)
from benchmark.core.weights import trainable
from benchmark.counts import bounds, flops
from benchmark.reference import rvt
from benchmark.reference import train as ref_train
from benchmark.reference.precision import BF16, F32, FP8, no_tf32

FIRST = 3  # the steps the reference follows
B1 = 0.9   # the first moment's decay (optax.adamw)


class Driver(BaseDriver):
    def setup(self, seconds: float) -> None:
        from rvt_tpu_torch.models.backbone import zero_states
        from rvt_tpu_torch.training.optimizer import make_optimizer
        from rvt_tpu_torch.training.step import make_train_step

        from benchmark.core.port import port_config, port_model

        A, tp, dev = self.A, self.tp, self.device
        self.B, self.T = tp["lanes"], A["sequence_length"]
        self.K = A["max_labeled_frames"]
        self.frames_per_call = self.B * self.T
        self.flops_per_call = flops.train_step(A, self.B, self.T, self.K)
        self.pc = port_config(self.cfg, stem_s2d=False)
        self.sd = self.weights()
        self.model = port_model(self.pc, self.sd, dev)
        self.opt = make_optimizer(self.model.parameters(), self.pc.training)
        self.step = make_train_step(self.model, self.pc, self.opt)
        self.pool = [self._batch(j) for j in range(tp["pool_batches"])]
        n_max = int(seconds * 200) + 64
        first = torch.from_numpy(self.rng.random((n_max, self.B))
                                 < tp["restart_p"])
        first[0] = True
        self.is_first = first.to(dev)
        self.states = zero_states(self.pc.model.backbone, self.B, device=dev)
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        names = [n for n, _ in self.model.named_parameters()]
        # the first three steps, through the window's own call
        self.first = []
        for s in range(FIRST):
            m = self._step(s, s)
            self.first.append({k: float(v) for k, v in m.items()})
            if s == 0:
                self.g1 = {n: mu.detach().clone() / (1 - B1)
                           for n, mu in zip(names, self.opt.mu)}
        self.p3 = {n: p.detach().clone()
                   for n, p in self.model.named_parameters()}
        self.b3 = {n: b.detach().clone()
                   for n, b in self.model.named_buffers()}
        self.s3 = self.states
        self.offset = FIRST

    def _batch(self, j: int):
        """One window of the pool: (ev, labels, label_mask, frame_valid)."""
        tp, A, dev = self.tp, self.A, self.device
        H, W = A["resolution_hw"]
        C, M = 2 * A["bins"], A["max_labels_per_frame"]
        B, T = self.B, self.T
        g = self.gen(100 + j)
        lo, hi = tp["density"]
        ev = torch.empty(B, T, H, W, C, dtype=torch.uint8, device=dev)
        for b in range(B):
            d = lo + (hi - lo) * float(torch.rand(1, generator=g, device=dev))
            v = torch.randint(0, tp["max_count"], (T, H, W, C), generator=g,
                              device=dev, dtype=torch.uint8)
            ev[b] = v * (torch.rand((T, H, W, C), generator=g, device=dev)
                         < d)
        rng = np.random.default_rng([self.seed, 11, j])
        labels = np.zeros((B, T, M, 7), np.float32)
        mask = np.zeros((B, T, M), bool)
        every = tp["label_every"]
        for b in range(B):
            phase = int(rng.integers(0, every))
            for t in range(T):
                if (t + phase) % every != every - 1:
                    continue
                n = int(rng.integers(tp["boxes"][0], tp["boxes"][1] + 1))
                side = rng.uniform(*tp["box_side"], size=(n, 2))
                x = rng.uniform(0, W - side[:, 0])
                y = rng.uniform(0, H - side[:, 1])
                cls = rng.integers(0, A["num_classes"], n)
                labels[b, t, :n] = np.stack(
                    [np.full(n, 50_000.0 * t), x, y, side[:, 0], side[:, 1],
                     cls, np.ones(n)], -1)
                mask[b, t, :n] = True
        labels, mask = (torch.from_numpy(a).to(dev) for a in (labels, mask))
        return ev, labels, mask, mask.any(-1)

    def bound_per_call(self) -> float:
        return bounds.train_step(self.A, self.B, self.T)

    def _step(self, s: int, j: int):
        ev, labels, mask, fv = self.pool[j % len(self.pool)]
        self.states, m = self.step(self.states, ev, labels, mask, fv,
                                   self.is_first[s])
        self.nonfinite += (~torch.isfinite(m["loss"])).long()
        return m

    def call(self, i: int) -> None:
        s = self.offset + i
        self._step(s, s)
        self.attempted += 1

    def finish(self) -> None:
        self.failed = int(self.nonfinite)

    # ------------------------------------------------------------ check

    def _reference(self, prec, lanes=None):
        """The reference through the first three steps: (per-step metrics,
        first clipped gradient, leaves after step 3, buffers after step
        3, final states)."""
        A = self.A
        keys = trainable(A)
        P = {k: v.detach().clone().float() if v.is_floating_point()
             else v.clone() for k, v in self.sd.items()}
        opt = ref_train.AdamW({k: P[k] for k in keys}, self.cfg["training"])
        B = self.B if lanes is None else lanes
        states = rvt.zero_states(A, B, self.device)
        out, g1 = [], None
        for s in range(FIRST):
            ev, labels, mask, _ = self.pool[s % len(self.pool)]
            m, clipped, states = ref_train.train_step(
                P, keys, opt, A, states, ev[:B], labels[:B], mask[:B],
                self.is_first[s][:B], self.K, prec)
            out.append(m)
            if g1 is None:
                g1 = clipped
        return out, g1, P, states

    def _readings(self, got, ref):
        """The numbers compared (``loss_gap``: each step's loss;
        ``grad_leaf_median``: the median leaf's first gradient as the
        optimizer took it; ``update_leaf_median``: the median moved leaf's
        change over the three steps; ``buffer_gap``: the worst BatchNorm
        buffer's change; ``state_rms_gap``: the final states), then the
        look, read and not compared: the worst leaves, the gradient's
        norm, SimOTA's foreground count."""
        (m_g, g1_g, P_g, s_g), (m_r, g1_r, P_r, s_r) = got, ref
        A = self.A
        keys = trainable(A)
        p0 = self.sd
        nr = {k: float(torch.linalg.vector_norm(g1_r[k])) for k in keys}
        med = float(np.median(list(nr.values())))
        moved = [k for k in keys if nr[k] >= 1e-3 * med]
        bufs = [k for k in p0 if k.endswith(("running_mean", "running_var"))]

        def change(P, ks):
            return {k: P[k].float() - p0[k].float() for k in ks}
        grads = leaf_gaps(g1_g, g1_r, keys)
        updates = leaf_gaps(change(P_g, moved), change(P_r, moved), moved)
        r = {"loss_gap": max(abs(g["loss"] - f["loss"]) / abs(f["loss"])
                             for g, f in zip(m_g, m_r)),
             "grad_leaf_median": float(np.median(list(grads.values()))),
             "update_leaf_median": float(np.median(list(updates.values()))),
             "buffer_gap": norm_gap(change(P_g, bufs), change(P_r, bufs),
                                    bufs),
             "grad_leaf_gap": max(grads.values()),
             "update_leaf_gap": max(updates.values()),
             "grad_norm_gap": max(abs(g["grad_norm"] - f["grad_norm"])
                                  / f["grad_norm"] for g, f in zip(m_g, m_r)),
             "num_fg_gap": max(abs(g["num_fg"] - f["num_fg"]) / f["num_fg"]
                               for g, f in zip(m_g, m_r))}
        r["state_rms_gap"] = max(
            float(torch.linalg.vector_norm(g.float() - f.float())
                  / torch.linalg.vector_norm(f.float()))
            for gs, fs in zip(s_g, s_r) for g, f in zip(gs, fs))
        r["state_gap"] = states_gap(s_g, s_r)
        self.look = {"worst_grad_leaves": sorted(
            grads, key=grads.get, reverse=True)[:4],
            "worst_update_leaves": sorted(
                updates, key=updates.get, reverse=True)[:4],
            "num_fg": [(g["num_fg"], f["num_fg"]) for g, f in zip(m_g, m_r)],
            "grad_norm": [(g["grad_norm"], f["grad_norm"])
                          for g, f in zip(m_g, m_r)],
            "loss": [(g["loss"], f["loss"]) for g, f in zip(m_g, m_r)],
            "norm_top": norm_top(g1_g, g1_r, keys)}
        return r

    def check(self, control: bool = False, extra=()):
        """The program's readings and, with ``control``, the control's
        (the reference with float8 operands and gradients in the
        program's place). ``extra`` adds, under ``<name>:<number>``, the
        reference in the program's place with half of the lanes left out
        (``half_batch``) or in bfloat16 (``bf16``, the configuration's own
        precision: what rounding alone reads)."""
        got = (self.first, self.g1, {**self.p3, **self.b3}, self.s3)
        with no_tf32():
            ref = self._reference(F32)
            readings = self._readings(got, ref)
            look = self.look
            cread = self._readings(self._reference(FP8), ref) if control \
                else None
            for name in extra:
                cread = dict(cread or {})
                if name == "half_batch":
                    m, g1, P, st = self._reference(F32, self.B // 2)
                    # the lanes left out keep the zero states they had
                    st = tuple(tuple(torch.cat([x, torch.zeros_like(x)])
                                     for x in hc) for hc in st)
                    r = self._readings((m, g1, P, st), ref)
                elif name == "bf16":
                    r = self._readings(self._reference(BF16), ref)
                else:
                    raise ValueError(f"no extra reading {name!r}")
                cread.update({f"{name}:{n}": v for n, v in r.items()})
        self.look = look
        return readings, cread


def norm_top(got, ref, keys, n: int = 6):
    """The leaves that carry most of the reference's first (clipped)
    gradient: (leaf, its share of the squared norm, the program's share,
    the leaf's gap of norms)."""
    sq_r = {k: float(ref[k].float().pow(2).sum()) for k in keys}
    sq_g = {k: float(got[k].float().pow(2).sum()) for k in keys}
    tot_r, tot_g = sum(sq_r.values()), sum(sq_g.values())
    gaps = leaf_gaps(got, ref, keys)
    top = sorted(keys, key=lambda k: -max(sq_r[k], sq_g[k]))[:n]
    return [(k, sq_r[k] / tot_r, sq_g[k] / tot_g, gaps[k]) for k in top]

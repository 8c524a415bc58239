"""What every traffic driver shares: the cell's numbers, the seeded
generators, the program's weights, the sample of calls the check holds
against the reference, and the gap measures the checks compare.

A driver (``traffic/<kind>.py:Driver``) is made with the cell's
configuration and workload files, the seed and the device, and then:

- ``setup(seconds)`` makes the inputs from the seed, builds the port's
  entry with the harness's weights and warms up every shape it will use;
- ``call(i)`` / ``finish()`` run the window (``core/loop.py``);
- ``release()`` frees the program's state once the window has closed;
- ``check(control)`` runs the reference on what the window produced and
  returns the numbers compared, and with ``control`` the control's
  readings of the same numbers (the reference in float8 in the
  program's place);
- ``frames_per_call``, ``flops_per_call`` and ``bound_per_call`` (the
  hand-written kernels' least time, ``counts/bounds.py``) describe one
  call; ``latencies`` holds each call's latency where the kind has one.

``fault`` names a fault planted in the timed path for the checks' own
tests (``tests/test_bench_faults.py``): the harness never sets it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.core.weights import generator, make_state_dict


class BaseDriver:
    frames_per_call = 0
    flops_per_call = 0.0

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed = cfg, wl, int(seed)
        self.A = cfg["model"]
        self.tp = wl["traffic_params"]
        self.device = torch.device(device)
        self.rng = np.random.default_rng([self.seed, 7])
        self.latencies: List[float] = []
        self.attempted = 0
        self.failed = 0

    def gen(self, stream: int) -> torch.Generator:
        return generator(self.seed, self.device, stream)

    def weights(self) -> Dict[str, torch.Tensor]:
        return make_state_dict(self.A, self.seed, self.device,
                               self.wl.get("weights"))

    def bound_per_call(self) -> float:
        raise NotImplementedError

    def sample_calls(self, expected: int, n: int) -> List[int]:
        """The calls the check compares: the first and ``n`` drawn from
        the seed among the first four fifths of the calls the window is
        expected to make (from the warm-up's pace)."""
        hi = max(2, int(0.8 * expected))
        drawn = self.rng.choice(np.arange(1, hi), size=min(n, hi - 1),
                                replace=False)
        return sorted({0, *map(int, drawn)})

    def release(self) -> None:
        """Free the program's state (the weights it holds, its graphs)."""
        for name in ("step", "model", "opt"):
            if hasattr(self, name):
                delattr(self, name)


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / max(scale, 1e-30)


def channel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst channel (last axis) of max |got - ref| over the standard
    deviation of ref's channel: a gap against the signal, not against an
    offset (the head's biases) that every output shares."""
    d = (got.float() - ref.float()).reshape(-1, ref.shape[-1]).abs()
    sd = ref.float().reshape(-1, ref.shape[-1]).std(0).clamp(min=1e-30)
    return float((d.amax(0) / sd).max())


def states_gap(got, ref) -> float:
    """The worst stage's h or c, by ``rel_gap``."""
    return max(rel_gap(g, r) for gs, rs in zip(got, ref)
               for g, r in zip(gs, rs))


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys) -> Dict[str, float]:
    """Each leaf's gap of norms: | |got| - |ref| | over the larger of |ref|
    and the median leaf's |ref|."""
    ng = {k: float(torch.linalg.vector_norm(got[k].float())) for k in keys}
    nr = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keys}
    med = float(np.median(list(nr.values())))
    return {k: abs(ng[k] - nr[k]) / max(nr[k], med, 1e-30) for k in keys}


def norm_gap(got, ref, keys) -> float:
    """The worst leaf's ``leaf_gaps``."""
    return max(leaf_gaps(got, ref, keys).values())


def fold(worst: dict, readings: dict) -> None:
    """Each reading into ``worst``, the largest so far."""
    for n, v in readings.items():
        worst[n] = max(worst.get(n, 0.0), v)


def add(total: list, part: tuple) -> None:
    """(count, of) into a running ``total``."""
    total[0] += part[0]
    total[1] += part[1]


def detection_mismatch(ref_dets, dets, valid, tol: float = 1e-3) -> int:
    """Frames whose detections differ: ``ref_dets`` a list of [n, 7], one
    a frame; ``dets`` [F, max, 7] and ``valid`` [F, max] the program's,
    frame by frame. A frame differs in its number of valid rows, or in a
    row by more than ``tol`` of the frame's largest coordinate."""
    bad = 0
    for f, r in enumerate(ref_dets):
        got = torch.as_tensor(dets[f])[torch.as_tensor(valid[f])].float()
        r = r.cpu().float()
        if got.shape[0] != r.shape[0]:
            bad += 1
        elif r.shape[0] and float((got - r).abs().max()) > tol * max(
                float(r[:, :4].abs().max()), 1.0):
            bad += 1
    return bad


def stage_mismatch(post, preds, dets, valid, nms: float,
                   delta: float = 1e-4) -> tuple:
    """The postprocess stage by itself: (frames whose detections differ
    from ``post(preds, nms)``, the reference's postprocess of the
    program's own head outputs, at the NMS threshold and at the threshold
    moved by +-``delta``; frames that match only so). An IoU that lies
    within rounding of the threshold may go either way: the program
    compares class-offset boxes, the reference each class's own."""
    bad = near = 0
    ref = post(preds, nms)
    for f in range(len(ref)):
        one = (dets[f:f + 1], valid[f:f + 1])
        if not detection_mismatch(ref[f:f + 1], *one):
            continue
        if all(detection_mismatch(post(preds[f:f + 1], nms + s), *one)
               for s in (-delta, delta)):
            bad += 1
        else:
            near += 1
    return bad, near


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of x1, y1, x2, y2 boxes a [n, 4] and b [m, 4] -> [n, m]."""
    tl = torch.maximum(a[:, None, :2], b[None, :, :2])
    br = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (br - tl).clamp(min=0).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp(
        min=1e-12)


def unmatched(got: torch.Tensor, ref: torch.Tensor, iou: float) -> int:
    """Detections of one frame ([n, 7] and [m, 7], class in the last
    column) that find no partner: each reference detection, by its
    order, takes the unclaimed detection of its class that overlaps it
    most, if by ``iou`` or more."""
    got, ref = got.cpu().float(), ref.cpu().float()
    if not len(got) or not len(ref):
        return len(got) + len(ref)
    ov = box_iou(ref[:, :4], got[:, :4])
    ov[ref[:, 6][:, None] != got[:, 6][None, :]] = 0.0
    free = torch.ones(len(got), dtype=torch.bool)
    matched = 0
    for i in range(len(ref)):
        row = torch.where(free, ov[i], torch.zeros_like(ov[i]))
        j = int(row.argmax())
        if float(row[j]) >= iou:
            free[j] = False
            matched += 1
    return len(got) + len(ref) - 2 * matched


def det_gap(got, ref, iou: float = 0.9) -> tuple:
    """(detections without a partner, all detections) over frames:
    ``got`` and ``ref`` lists of [n, 7] per frame."""
    miss = sum(unmatched(g, r, iou) for g, r in zip(got, ref))
    return miss, sum(len(g) + len(r) for g, r in zip(got, ref))


def host_dets(dets, valid):
    """The program's detections, [F, max, 7] and [F, max], as a list of
    [n, 7] per frame."""
    return [torch.as_tensor(d)[torch.as_tensor(v)] for d, v in
            zip(dets, valid)]

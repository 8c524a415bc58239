"""The port's Prophesee protocol (rvt_tpu_torch.evaluation: prophesee.py
and the COCO matcher of coco.py) against the JAX package's, each matching
through its native library (the same in-repo file) and, with the
libraries switched off, through their numpy matchers: all six stats,
equal, over random GT and detection sets (empty frames, a class without
GT, tied scores, boxes the size filter drops), gen1 and gen4 with
``downsample_by_2``; and the buffers' serialisation round trip."""
import numpy as np
import pytest

from rvt_tpu import native_lib
from rvt_tpu.evaluation.prophesee import PropheseeEvaluator as JEvaluator
from rvt_tpu_torch import native_lib as t_native_lib
from rvt_tpu_torch.evaluation.prophesee import (BBOX_DTYPE,
                                                PropheseeEvaluator)

STATS = ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L")
CASES = [("gen1", False, 0), ("gen1", False, 1), ("gen1", False, 2),
         ("gen4", False, 3), ("gen4", True, 4), ("gen4", True, 5)]


def _frames(seed, dataset, ds2, n_frames=40):
    """Per-frame (gt, pred) BBOX_DTYPE arrays: GT boxes of random size
    (some below the protocol's size filter), detections jittered around
    them plus false positives, scores on a 0.05 grid (ties), the last
    class never in GT, every 7th frame empty."""
    rng = np.random.RandomState(seed)
    n_cls = 2 if dataset == "gen1" else 3
    h, w = (240, 304) if dataset == "gen1" else (360, 640)
    gts, preds = [], []
    for f in range(n_frames):
        t = 600_000 + 50_000 * f
        n_gt = 0 if f % 7 == 3 else rng.randint(0, 6)
        gt = np.zeros(n_gt, BBOX_DTYPE)
        gt["t"] = t
        gt["w"], gt["h"] = rng.uniform(6, 120, n_gt), rng.uniform(6, 90, n_gt)
        gt["x"] = rng.uniform(0, w - gt["w"])
        gt["y"] = rng.uniform(0, h - gt["h"])
        gt["class_id"] = rng.randint(0, n_cls - 1, n_gt)
        gt["class_confidence"] = 1.0
        n_tp = rng.binomial(n_gt, 0.7)
        n_fp = 0 if f % 7 == 3 else rng.randint(0, 5)
        pr = np.zeros(n_tp + n_fp, BBOX_DTYPE)
        pr["t"] = t
        src = gt[rng.choice(n_gt, n_tp, replace=False)] if n_tp else gt[:0]
        for k in ("x", "y", "w", "h"):
            pr[k][:n_tp] = src[k] * rng.uniform(0.85, 1.15, n_tp)
        pr["class_id"][:n_tp] = np.where(rng.rand(n_tp) < 0.85,
                                         src["class_id"],
                                         rng.randint(0, n_cls, n_tp))
        pr["w"][n_tp:] = rng.uniform(10, 100, n_fp)
        pr["h"][n_tp:] = rng.uniform(10, 80, n_fp)
        pr["x"][n_tp:] = rng.uniform(0, w - 100, n_fp)
        pr["y"][n_tp:] = rng.uniform(0, h - 80, n_fp)
        pr["class_id"][n_tp:] = rng.randint(0, n_cls, n_fp)
        pr["class_confidence"] = np.round(rng.uniform(0.05, 1.0, len(pr))
                                          / 0.05) * 0.05
        gts.append(gt)
        preds.append(pr)
    return gts, preds


def _evaluate(cls, dataset, ds2, gts, preds):
    ev = cls(dataset, ds2)
    ev.add_labels(gts)
    ev.add_predictions(preds)
    h, w = (240, 304) if dataset == "gen1" else (360, 640)
    return ev.evaluate_buffer(img_height=h, img_width=w)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("dataset,ds2,seed", CASES)
def test_protocol_equals_jax(monkeypatch, dataset, ds2, seed, native):
    for lib in (native_lib, t_native_lib):
        if native:
            assert lib.get_lib() is not None
        else:
            monkeypatch.setattr(lib, "coco_match_image",
                                lambda *a, **k: None)
    gts, preds = _frames(seed, dataset, ds2)
    got = _evaluate(PropheseeEvaluator, dataset, ds2, gts, preds)
    want = _evaluate(JEvaluator, dataset, ds2, gts, preds)
    assert set(got) == set(STATS) == set(want)
    assert got == want
    assert 0.0 < got["AP"] < 1.0


def test_no_detections_and_no_labels():
    gts, preds = _frames(0, "gen1", False, 10)
    empty = [p[:0] for p in preds]
    for cls in (PropheseeEvaluator, JEvaluator):
        assert _evaluate(cls, "gen1", False, gts, empty) == {
            k: 0.0 for k in STATS}
        assert cls("gen1").evaluate_buffer(240, 304) is None


@pytest.mark.parametrize("dataset,ds2,seed", CASES[2:5])
def test_buffer_bytes_round_trip(dataset, ds2, seed):
    """Buffers serialised on one side and appended on the other, both
    ways between the packages, then scored: the same stats as one
    evaluator holding every frame."""
    gts, preds = _frames(seed, dataset, ds2)
    half = len(gts) // 2
    whole = _evaluate(PropheseeEvaluator, dataset, ds2, gts, preds)
    for first, second in ((PropheseeEvaluator, JEvaluator),
                          (JEvaluator, PropheseeEvaluator)):
        a = first(dataset, ds2)
        a.add_labels(gts[:half])
        a.add_predictions(preds[:half])
        b = second(dataset, ds2)
        b.add_labels(gts[half:])
        b.add_predictions(preds[half:])
        merged = PropheseeEvaluator(dataset, ds2)
        merged.extend_from_bytes(a.state_bytes())
        merged.extend_from_bytes(b.state_bytes())
        assert len(merged._labels) == len(gts)
        for x, y in zip(merged._labels + merged._predictions, gts + preds):
            assert x.dtype == BBOX_DTYPE
            np.testing.assert_array_equal(x, y)
        h, w = (240, 304) if dataset == "gen1" else (360, 640)
        assert merged.evaluate_buffer(h, w) == whole

"""The frozen FLOP and bound counts at the cells' shapes, pinned to the
hand-worked totals."""
import json

import pytest

from benchmark.core.manifest import BENCH_DIR
from benchmark.counts import bounds, flops


def arch(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text()
                      )["model"]


@pytest.mark.parametrize("name, window_gflop, step_tflop", [
    ("rvtb_gen1", 1341.3, 4.024), ("rvts_gen1", 775.8, 2.327)])
def test_eval_window_and_train_step_flops(name, window_gflop, step_tflop):
    A = arch(name)
    assert flops.eval_window(A, 8, 21, 6) / 1e9 == pytest.approx(
        window_gflop, abs=0.05)
    assert flops.train_step(A, 8, 21, 6) / 1e12 == pytest.approx(
        step_tflop, abs=5e-4)


def test_raw_call_flops():
    assert flops.raw_call(arch("rvtb_gen1"), 8) / 1e9 == pytest.approx(
        84.1, abs=0.05)


def test_eval_counts_neck_and_head_on_gathered_frames_only():
    A = arch("rvtb_gen1")
    f = flops.per_frame(A)
    assert f["total"] * 168 / 1e9 == pytest.approx(1767.0, abs=0.1)
    assert flops.eval_window(A, 8, 21, 6) < f["total"] * 168


@pytest.mark.parametrize("name, eval_ms, train_ms", [
    ("rvtb_gen1", 0.9788, 2.9363), ("rvts_gen1", 0.5631, 1.6892)])
def test_stage_bounds(name, eval_ms, train_ms):
    """chip_smoke.py:stage_bounds' rows 3 and 8 (RVT-B: 0.979 and 2.936
    ms, both by operations), plus NMS over 48 frames of no candidate."""
    A = arch(name)
    assert bounds.eval_window(A, 8, 21, 6) * 1e3 == pytest.approx(
        eval_ms, abs=1e-3)
    assert bounds.train_step(A, 8, 21) * 1e3 == pytest.approx(train_ms,
                                                              abs=1e-3)


def test_voxelizer_bound():
    """32768 events in each of 8 lanes at gen1: 0.0047 ms by bytes
    (chip_smoke.py's row 6)."""
    assert bounds.voxelizer(8 * 32768, 8, 10, 240, 304) * 1e3 == \
        pytest.approx(0.0047, abs=1e-4)

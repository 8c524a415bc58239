"""The readers of the program's own tracing (``readers/_program.py``):
each metric whose source is the program's counters has its reader, reads
a made-up ``timers.summary()`` as its docstring says (per step call, a
layer's device time, the counters), gives None for a program without
that tracing (a checkout from before it, which the readers run over
when it is compared with a later one), and reads a traced tiny run on
the CPU (whose layers have no device time)."""
import json
import time

import pytest

from benchmark.core.cell import run_cell
from benchmark.core.manifest import ROOT, Manifest
from benchmark.tests.tiny import KINDS, tiny_copy

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = [m for m in SPEC["per_layer"] if m["source"] == "program_counter"
           and not m["name"].startswith("peak_mem_gib")]


def _span(count, host_s, self_s, device_s=0.0, device_count=0):
    return {"count": count, "host_s": host_s, "self_s": self_s,
            "device_s": device_s, "device_count": device_count}


# two step calls: the spans' host and device time
FAKE = {"spans": {
    "step": _span(2, 0.010, 0.001),
    "step.before": _span(2, 0.001, 0.001, 0.0002, 2),
    "step.copy_in": _span(2, 0.002, 0.002, 0.0010, 2),
    "step.replay": _span(2, 0.003, 0.003, 0.0300, 2),
    "step.copy_out": _span(2, 0.001, 0.001, 0.0004, 2),
    "feed.window_input": _span(2, 0.0006, 0.0006, 0.0008, 2),
    "eval.fetch": _span(2, 0.0004, 0.0004, 0.0002, 2),
    "input": _span(2, 0, 0, 0.0020, 2),
    "backbone": _span(2, 0, 0, 0.0100, 2),
    "detect": _span(2, 0, 0, 0.0040, 2),
    "loss": _span(2, 0, 0, 0.0030, 2),
    "detect_bwd": _span(2, 0, 0, 0.0050, 2),
    "backbone_bwd": _span(2, 0, 0, 0.0020, 2),
    "optimizer": _span(2, 0, 0, 0.0016, 2),
    "postprocess": _span(2, 0, 0, 0.0012, 2)},
    "counters": {"launches": {"sum": 300, "items": 2, "count": 2},
                 "nms_candidates": {"sum": 120, "items": 24, "count": 2}}}
EXPECT = {"input_ms": 1e3 * (0.0020 + 0.0010 + 0.0008) / 2,
          "backbone_ms": 5.0, "detect_ms": 2.0, "loss_ms": 1.5,
          "detect_bwd_ms": 2.5, "backbone_bwd_ms": 1.0, "optimizer_ms": 0.8,
          "postprocess_ms": 0.6, "hand_launches": 150.0, "nms_candidates": 5.0}


def test_every_program_metric_is_read():
    assert {m["name"].split(".")[0] for m in PROGRAM} == set(EXPECT)
    assert len(PROGRAM) == 20
    for m in PROGRAM:
        assert m["workloads"] and all(
            w in [c["name"] for c in SPEC["workloads"]]
            for w in m["workloads"])


@pytest.mark.parametrize("entry", PROGRAM, ids=lambda e: e["name"])
def test_reads_a_made_up_summary(entry, monkeypatch):
    from rvt_tpu_torch.utils import timers

    monkeypatch.setattr(timers, "summary", lambda: FAKE)
    read = Manifest().reader(entry["name"])
    assert read(None) == pytest.approx(EXPECT[entry["name"].split(".")[0]])
    # no step call traced, or no device reading of the layer: nothing
    monkeypatch.setattr(timers, "summary", lambda: {
        "spans": dict(FAKE["spans"], step=_span(0, 0, 0)),
        "counters": FAKE["counters"]})
    assert read(None) is None


@pytest.mark.parametrize("entry", PROGRAM, ids=lambda e: e["name"])
def test_a_program_without_tracing_reads_nothing(entry, monkeypatch):
    from rvt_tpu_torch.utils import timers

    monkeypatch.delattr(timers, "summary")
    assert Manifest().reader(entry["name"])(None) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("kind", KINDS)
def test_traced_tiny_run(tiny, kind):
    """Traced on the CPU, the counters read; the layers have host times
    only, so their device metrics are left out."""
    from rvt_tpu_torch.utils import timers

    timers.reset()
    r = run_cell(f"tiny.{kind}", 77, 0.3, True, t_start=time.perf_counter(),
                 device="cpu", manifest=tiny, log=lambda *a: None)
    timers.reset()
    suffix = {"window_eval": "eval", "tbptt_train": "train",
              "raw_stream": "raw"}[kind]
    got = {n.split(".")[0]: v["value"] for n, v in r["metrics"].items()
           if n.endswith("." + suffix)}
    assert got["hand_launches"] == 0
    assert ("nms_candidates" in got) == (kind != "tbptt_train")
    assert not {"input_ms", "backbone_ms", "detect_ms"} & set(got)

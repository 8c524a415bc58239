"""A copy of the benchmark with tiny cells (gen1 tiny, 64 x 80 events,
T = 5, two lanes) for the CPU tests: ``tiny.<kind>`` runs the port's
bf16 kernel path (their plain versions on the CPU), ``tiny32.<kind>``
its float32 module path."""
import json
import shutil
from pathlib import Path

from benchmark.core.manifest import BENCH_DIR, ROOT, Manifest

KINDS = ("window_eval", "tbptt_train", "raw_stream")
CELL = {"window_eval": "rvtb_gen1.window_eval",
        "tbptt_train": "rvtb_gen1.tbptt_train",
        "raw_stream": "rvtb_gen1.raw_stream"}


def tiny_model():
    from rvt_tpu_torch.config import preset

    pc = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=5)
    bb = pc.model.backbone
    return {"embed_dim": bb.embed_dim, "dim_head": bb.attention.dim_head,
            "fpn_depth": pc.model.fpn.depth, "resolution_hw": [64, 80],
            "in_res_hw": list(bb.in_res_hw),
            "partition_size": list(bb.attention.partition_size),
            "sequence_length": 5,
            "max_labeled_frames": pc.dataset.max_labeled_frames}


def tiny_copy(tmp: Path) -> Manifest:
    """``tmp`` holds BENCHMARK.json and benchmark/ with the tiny cells."""
    bench = tmp / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((BENCH_DIR / "configs" / "rvtb_gen1.json").read_text())
    for name, program in (("tiny", base["program"]),
                          ("tiny32", {"compute_dtype": "float32",
                                      "fused_kernels": False})):
        cfg = json.loads(json.dumps(base))
        cfg["preset"] = ["gen1", "tiny"]
        cfg["dataset_overrides"] = {"resolution_hw": [64, 80],
                                    "sequence_length": 5}
        cfg["program"] = program
        cfg["model"].update(tiny_model())
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "tests"})
        for kind in KINDS:
            wl = json.loads((BENCH_DIR / "workloads"
                             / f"{CELL[kind]}.json").read_text())
            wl["config"] = name
            tp = wl["traffic_params"]
            tp["lanes"] = 2
            tp.update({"window_eval": {"pool_windows": 2},
                       "tbptt_train": {"pool_batches": 3,
                                       "box_side": [5, 30]},
                       "raw_stream": {"events": [200, 1000],
                                      "events_padded": 1024,
                                      "pool_calls": 4}}[kind])
            wl["profile"] = {"after_s": 0.0, "calls": 2}
            cell = f"{name}.{kind}"
            (bench / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
            spec["workloads"].append({"name": cell, "config": name,
                                      "traffic": kind, "chips": 1,
                                      "why": "tests"})
            for m in spec["end_to_end"] + spec["per_layer"]:
                if CELL[kind] in m.get("workloads", []):
                    m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Manifest(root=tmp, bench_dir=bench)

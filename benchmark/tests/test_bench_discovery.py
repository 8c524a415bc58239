"""Adding a configuration, a cell and a per-layer metric is adding files:
in a copy of the benchmark, new files and BENCHMARK.json entries are
found by ``run.py`` and the manifest reader, and no file that was there
changes."""
import hashlib
import json
import subprocess
import sys

from benchmark.core.manifest import Manifest
from benchmark.tests.tiny import tiny_copy


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    tiny_copy(tmp_path)
    bench = tmp_path / "benchmark"
    before = digests(bench)
    cfg = json.loads((bench / "configs" / "rvtb_gen1.json").read_text())
    (bench / "configs" / "rvtb_gen1_copy.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "rvtb_gen1.raw_stream.json"
                     ).read_text())
    wl["config"] = "rvtb_gen1_copy"
    (bench / "workloads" / "rvtb_gen1_copy.raw_stream.json").write_text(
        json.dumps(wl))
    (bench / "readers" / "calls_done.py").write_text(
        '"""Calls completed in the window."""\n\n\n'
        "def read(run):\n    return float(run.window.calls)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "rvtb_gen1_copy", "source": "x",
                            "file": "benchmark/configs/rvtb_gen1_copy.json",
                            "reduced": [], "why": "a copy"})
    spec["workloads"].append({"name": "rvtb_gen1_copy.raw_stream",
                              "config": "rvtb_gen1_copy",
                              "traffic": "raw_stream", "chips": 1,
                              "why": "a copy"})
    spec["end_to_end"][2]["workloads"].append("rvtb_gen1_copy.raw_stream")
    spec["per_layer"].append({"name": "calls_done.raw", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness",
                              "moves": "raw_latency_p95_ms",
                              "workloads": ["rvtb_gen1_copy.raw_stream"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digests(bench)
    assert all(after[p] == d for p, d in before.items())

    m = Manifest(root=tmp_path, bench_dir=bench)
    wl = m.workload("rvtb_gen1_copy.raw_stream")
    assert m.config(wl["config"])["preset"] == ["gen1", "base"]
    assert m.traffic(wl["traffic"]).Driver
    assert "calls_done.raw" in [x["name"] for x in m.metrics_of(
        "rvtb_gen1_copy.raw_stream", True)]
    # run.py in the copy finds the new cell and its reader; without a
    # card it then exits 2 and prints no result
    probe = (
        "import sys; sys.path.insert(0, '.');"
        "from benchmark.core.manifest import Manifest;"
        "m = Manifest(); r = m.reader('calls_done.raw');"
        "print(r.__module__, m.workload('rvtb_gen1_copy.raw_stream')"
        "['config'])")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["benchmark.readers.calls_done",
                                  "rvtb_gen1_copy"]
    run = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "rvtb_gen1_copy.raw_stream", "--seed", "1", "--seconds", "1",
         "--trace", "1"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 2, run.stderr
    assert "needs 1 CUDA device" in run.stderr and run.stdout == ""


def test_run_refuses_an_unknown_cell(tmp_path):
    tiny_copy(tmp_path)
    run = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "no.such_cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout == ""

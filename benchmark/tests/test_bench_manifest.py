"""BENCHMARK.json against the files the harness reads: each cell's file
says what its entry says, each metric has a reader, each
configuration's file is the architecture the port's preset derives,
each cell's check has a limit for every number, and the file keeps the
contract's shapes."""
import json
import re

import pytest

from benchmark.core.manifest import BENCH_DIR, ROOT, Manifest
from benchmark.core.port import port_config

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("entry", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_every_metric_has_a_reader(entry):
    assert callable(Manifest().reader(entry["name"]))


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_workload_files_match(entry):
    wl = Manifest().workload(entry["name"])
    assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert wl["limits"] and all(v is not None
                                for v in wl["limits"].values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    m = Manifest()
    e2e = {x["name"] for x in m.metrics_of(entry["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert m.metrics_of(entry["name"], True)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_files_match_the_port(entry):
    cfg = Manifest().config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert (BENCH_DIR.parent / entry["file"]).is_file()
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
    port_config(cfg, stem_s2d=False)  # raises if the numbers drifted

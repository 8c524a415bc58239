"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

A cell is ``workloads/<cell>.json``; its configuration
``configs/<config>.json``; its traffic kind's driver ``traffic/<kind>.py``;
a metric's reader ``readers/<stem>.py``, the stem being the metric's name
up to its first dot (``kernel_device_ms.train`` is read by
``readers/kernel_device_ms.py``). Adding a cell, a configuration, a
traffic kind or a metric is adding such files and an entry in
``BENCHMARK.json``; no file that is there changes.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Manifest:
    """``BENCHMARK.json`` and the files under ``bench_dir``."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _file(self, sub: str, name: str, ext: str) -> Path:
        if not NAME.match(name):
            raise ValueError(f"not a benchmark name: {name!r}")
        path = self.dir / sub / f"{name}{ext}"
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing (no {name!r} under "
                                    f"{sub}/)")
        return path

    def workload(self, name: str) -> dict:
        if name not in [w["name"] for w in self.spec["workloads"]]:
            raise KeyError(f"BENCHMARK.json lists no workload {name!r}")
        wl = json.loads(self._file("workloads", name, ".json").read_text())
        wl["name"] = name
        return wl

    def config(self, name: str) -> dict:
        cfg = json.loads(self._file("configs", name, ".json").read_text())
        cfg["name"] = name
        return cfg

    def traffic(self, kind: str):
        self._file("traffic", kind, ".py")
        return importlib.import_module(f"{self.dir.name}.traffic.{kind}")

    def reader(self, name: str):
        """The reader of metric ``name``: ``readers/<stem>.py:read``."""
        stem = name.split(".")[0]
        self._file("readers", stem, ".py")
        return importlib.import_module(f"{self.dir.name}.readers.{stem}").read

    def metrics_of(self, cell: str, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        ones: those whose ``workloads`` list the cell, and those without
        the key that move an end-to-end metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved
                                 else [])]

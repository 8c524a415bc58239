"""Metrics logging: JSONL always; TensorBoard when asked for and available.

A copy of ``rvt_tpu.utils.logging``. The durable record is a JSONL stream
(one line per logged step) that any dashboard can tail; TensorBoard
summaries go through ``torch.utils.tensorboard``, imported only when
``tensorboard=True`` and skipped when its package is missing.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    def __init__(self, path: Path, tensorboard: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.path.parent / "tb"))
            except ImportError:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()

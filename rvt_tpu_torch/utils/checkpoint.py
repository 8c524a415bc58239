"""Checkpoints: the best by a monitored metric, plus the most recent steps.

The contract of ``rvt_tpu.utils.checkpoint`` (upstream PL ModelCheckpoint
on val/AP, top-1 + last, ``callbacks/custom.py:8-31``) on ``torch.save``
files instead of orbax:

    <dir>/steps/<step>/state.pt   # the ``keep`` most recent steps
    <dir>/best/<step>/state.pt    # one slot: the best monitored metric
    <dir>/best.json               # {"best", "step", "monitor"}

The monitored metric is one to maximise (AP): a step becomes the best
when its metric is at least the best so far. The best lives in its own
slot, so recency-based deletion of ``steps/`` never evicts it. Each
``state.pt`` holds what ``TrainState`` holds: the model's state dict
(parameters and BatchNorm buffers), the optimizer's state (moments and
step count) and the host step. It is written under a temporary name and
moved into place with ``os.replace``, so a reader never sees half a file.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"


def _write(state: Dict[str, Any], step_dir: Path) -> None:
    step_dir.mkdir(parents=True, exist_ok=True)
    tmp = step_dir / f".{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, step_dir / STATE_FILE)


def _steps(root: Path) -> List[int]:
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).exists())


class CheckpointManager:
    def __init__(self, directory: Path, monitor: str = "AP", keep: int = 2):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.keep = keep
        self._best: Optional[float] = None
        meta = self.directory / "best.json"
        if meta.exists():
            self._best = json.loads(meta.read_text()).get("best")

    def step_dir(self, step: int) -> Path:
        """The directory of a kept step (what the artifact registry
        publishes)."""
        return self.directory / "steps" / str(step)

    def save(self, state: Dict[str, Any], step: int,
             metric: Optional[float] = None) -> None:
        """Write ``state`` (a dict of tensors and plain values, e.g.
        ``Trainer.state_dict()``) as ``step``; drop all but the ``keep``
        most recent steps; with a ``metric`` at least the best so far, also
        make it the best."""
        _write(state, self.step_dir(step))
        for old in _steps(self.directory / "steps")[:-self.keep]:
            shutil.rmtree(self.step_dir(old))
        if metric is not None and (self._best is None or metric >= self._best):
            self._best = float(metric)
            best_root = self.directory / "best"
            for old in _steps(best_root):
                shutil.rmtree(best_root / str(old))
            _write(state, best_root / str(step))
            tmp = self.directory / f".best.json.{os.getpid()}.tmp"
            tmp.write_text(json.dumps({"best": self._best, "step": step,
                                       "monitor": self.monitor}))
            os.replace(tmp, self.directory / "best.json")

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (the latest when None), or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self.step_dir(step) / STATE_FILE,
                          map_location=map_location, weights_only=True)

    def restore_best(self, map_location=None) -> Optional[Dict[str, Any]]:
        """The state with the best monitored metric (kept even after newer,
        worse steps rotate the recency window), or None."""
        step = self.best_step()
        if step is None:
            return None
        return torch.load(self.directory / "best" / str(step) / STATE_FILE,
                          map_location=map_location, weights_only=True)

    def best_step(self) -> Optional[int]:
        steps = _steps(self.directory / "best")
        return steps[-1] if steps else None

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory / "steps")
        return steps[-1] if steps else None
